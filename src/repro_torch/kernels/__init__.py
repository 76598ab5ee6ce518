"""Hand-written CUDA kernels and their dispatch."""
