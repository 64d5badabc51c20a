"""Hand-written CUDA kernels (``csrc/``) behind PyTorch wrappers."""
