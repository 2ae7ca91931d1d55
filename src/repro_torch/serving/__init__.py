"""Classify serving (engine, gated step, adapters, the ``Server``
API), ported from ``repro.serving``."""
