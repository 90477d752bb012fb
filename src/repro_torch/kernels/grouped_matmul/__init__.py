"""Expert-blocked grouped matmul over capacity bins (CUDA C++ for sm_90a)."""
