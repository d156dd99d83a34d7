"""Device-side ops: preprocessing, pooling, retrieval (with the fused
top-k CUDA kernels)."""
