"""Synthetic scenes, sequences and perturbations; offline camera tools (numpy)."""
