"""Flash-decode attention over a dense KV cache: CUDA kernel, wrapper and
plain version."""
