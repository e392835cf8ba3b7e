"""Hand-written GPU kernels, each beside its plain PyTorch version."""
