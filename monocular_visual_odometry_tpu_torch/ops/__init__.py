"""Geometry and feature functions in PyTorch, and the CUDA matcher."""
