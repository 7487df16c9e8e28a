"""PyTorch + CUDA port of the PICE serving system (see README.md)."""
