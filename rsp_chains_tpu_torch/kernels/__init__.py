"""Hand-written CUDA kernels of the chain and their plain PyTorch versions."""
