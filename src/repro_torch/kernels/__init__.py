"""Hand-written Hopper kernels of the serving path and their plain PyTorch
versions; ``ops`` is the entry point model code calls."""
