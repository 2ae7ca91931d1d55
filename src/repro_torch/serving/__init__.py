"""Classify and generate serving (engines, the gated step, continuous
batching, adapters, the ``Server`` API), ported from ``repro.serving``."""
