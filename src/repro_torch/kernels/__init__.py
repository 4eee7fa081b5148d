"""Hand-written CUDA kernels of the L2S decode path (``csrc/``), each with a
plain PyTorch twin in the same module; ``ops`` composes, builds and counts
them."""
