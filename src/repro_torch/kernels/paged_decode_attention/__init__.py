"""Paged flash-decode attention over float and quantized pools: CUDA
kernel, wrappers and plain versions."""
