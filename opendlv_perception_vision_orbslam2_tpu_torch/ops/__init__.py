"""Geometry and feature ops (plain PyTorch) and CUDA kernel wrappers."""
