"""Hand-written CUDA kernels for Hopper and their wrappers."""
