"""Decode attention over the First-Fit paged KV cache (CUDA C++ for sm_90a)."""
