"""Hand-written CUDA kernels for Hopper, their wrappers and oracles."""
