"""Tridiagonalization, tridiagonal eigensolvers and the CUDA kernels."""
