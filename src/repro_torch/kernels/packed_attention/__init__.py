"""Packed flash attention over First-Fit packed rows, forward and backward
(CUDA C++ for sm_90a)."""
