"""DistilBERT and its building blocks, ported from ``repro.models``."""
