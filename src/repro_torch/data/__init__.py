"""Byte tokenizer and synthetic QA corpus."""
