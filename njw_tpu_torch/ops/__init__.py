"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions."""
