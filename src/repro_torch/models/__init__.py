"""Dense GQA decoder, paged KV cache and attention (PyTorch)."""
