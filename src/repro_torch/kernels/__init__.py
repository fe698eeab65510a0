"""Hand-written CUDA kernels of the port, with their plain versions."""
