"""Stencil kernels: plain PyTorch references and the CUDA kernels."""
