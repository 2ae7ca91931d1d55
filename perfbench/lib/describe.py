"""The module that describes a configuration's model: its plain reference
and the counts that go with its layout.

A configuration file (``perfbench/configs/<name>.json``) names it with
``"reference"``, a path under ``perfbench/``; without the key it is
``reference/lm.py``, the dense and MoE GQA decoders.  The module is
loaded by path, as a metric reader is, so a new one needs no import
anywhere.  It provides these functions, and the harness reads a layout
through them alone:

- ``dims(m)``: the sizes of the file's ``model`` block, a dict that
  holds at least ``L`` (layers), ``V`` (vocabulary) and ``dtype`` (the
  served ``torch.dtype``);
- ``specs(m)``: ``(name, shape, kind)`` of every parameter, in drawing
  order, with the port's ``named_parameters()`` names and kinds from
  ``weights.KINDS``;
- ``logits(z, weight, tokens, at, act=...)``: float32 logits ``[len(at),
  V]`` at positions ``at`` of one causal pass over ``tokens`` ``[S]``,
  TF32 off; ``weight(name)`` gives a parameter as float32 and ``act`` is
  applied to every input of a product with a weight;
- ``cache_row_bytes(z)``: the bytes one cached token takes over every
  layer;
- ``matmul_params(z)``: the parameters one token multiplies through;
- ``attention_flops(z, pairs)``: the operations of ``pairs`` (query, key)
  pairs over every layer;
- ``decode_attention_bytes(z, rows, queries)``: the bytes decode
  attention reads and writes over every layer for ``rows`` cached rows
  and ``queries`` query rows.

``z`` is what ``dims`` returned.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DEFAULT = "reference/lm.py"
FUNCTIONS = ("dims", "specs", "logits", "cache_row_bytes", "matmul_params",
             "attention_flops", "decode_attention_bytes")


def path_of(model_file: dict) -> str:
    """The reference module's path under ``perfbench/``, checked."""
    rel = model_file.get("reference", DEFAULT)
    if not (re.fullmatch(r"[A-Za-z0-9_.-]+(/[A-Za-z0-9_.-]+)*\.py", rel)
            and ".." not in rel.split("/")):
        raise ValueError(f"'reference' has to be a .py path under perfbench/: {rel!r}")
    if not (HERE / rel).is_file():
        raise FileNotFoundError(f"no reference module perfbench/{rel}")
    return rel


def load(model_file: dict):
    """The module a configuration file names, with every function of the
    contract."""
    rel = path_of(model_file)
    name = "perfbench_reference_" + re.sub(r"\W", "_", rel[:-3])
    spec = importlib.util.spec_from_file_location(name, HERE / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"perfbench/{rel} lacks {missing}")
    return mod
