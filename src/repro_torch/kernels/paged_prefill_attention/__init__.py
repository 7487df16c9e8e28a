"""Paged chunked-prefill attention: CUDA kernel, wrappers and plain versions."""
