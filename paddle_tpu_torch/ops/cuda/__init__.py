"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Nothing is built at import; see build.py."""
