"""The decision step (K1 and its plain PyTorch version) and the kernel
build."""
