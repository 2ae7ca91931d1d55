"""DistilBERT, the decoder LM for attention stacks and their building
blocks, ported from ``repro.models``."""
