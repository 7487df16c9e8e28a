"""Full-sequence flash attention: CUDA kernel, wrapper and plain version."""
