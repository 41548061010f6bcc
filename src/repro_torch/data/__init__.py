"""Deterministic synthetic data."""
from repro_torch.data.pipeline import SyntheticImages

__all__ = ["SyntheticImages"]
