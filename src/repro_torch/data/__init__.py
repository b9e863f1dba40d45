"""Deterministic synthetic training data."""
from repro_torch.data.pipeline import DataConfig, synthetic_batch_iterator
