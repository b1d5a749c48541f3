"""Diffusion operators, ranking, metrics, propagation and the CUDA kernels."""
