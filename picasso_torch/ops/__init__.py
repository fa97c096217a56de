"""Device math of the port: plain PyTorch versions and the wrappers of
the hand-written CUDA kernels beside them."""
