"""Config dataclasses and trajectory metrics."""
