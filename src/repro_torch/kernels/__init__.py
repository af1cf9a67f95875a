"""Hand-written CUDA kernels of the port (``csrc/``), their launch
wrappers, plain PyTorch versions and the backend seam."""
