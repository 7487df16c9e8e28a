"""Paged flash-decode attention: CUDA kernel, wrapper and plain version."""
