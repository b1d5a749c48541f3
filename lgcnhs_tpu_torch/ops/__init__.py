"""Diffusion operators, top-k ranking and the CUDA kernels."""
