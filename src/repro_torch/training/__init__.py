"""Synthetic request data, ported from ``repro.training.data``."""
