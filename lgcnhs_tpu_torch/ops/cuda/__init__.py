"""Hand-written Hopper kernels, their build, and their plain PyTorch twins."""
