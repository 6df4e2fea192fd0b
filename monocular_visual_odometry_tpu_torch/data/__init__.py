"""Synthetic benchmark data (numpy)."""
