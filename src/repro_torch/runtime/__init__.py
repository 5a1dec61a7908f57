"""Serving runtime: the paged KV cache, continuous batching, the Engine."""
