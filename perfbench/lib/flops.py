"""Counts that no layout decides.  The operations and bytes of a model's
work live with its reference module (``perfbench/lib/describe.py``:
``matmul_params``, ``attention_flops``, ``decode_attention_bytes``),
counted once: each input byte read once and each output byte written
once, whatever a kernel reads again."""
from __future__ import annotations


def causal_pairs(S: int) -> int:
    """(query, key) pairs of a causal prompt of ``S`` tokens."""
    return S * (S + 1) // 2
