"""Deterministic synthetic data."""
from repro_torch.data.pipeline import SyntheticImages, SyntheticTokens

__all__ = ["SyntheticImages", "SyntheticTokens"]
