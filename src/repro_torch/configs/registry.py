"""``--arch <id>`` resolution for launchers, benchmarks and tests."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "minicpm3-4b": "minicpm3_4b",
    "whisper-medium": "whisper_medium",
    "internlm2-20b": "internlm2_20b",
    "dbrx-132b": "dbrx_132b",
    "stablelm-3b": "stablelm_3b",
    "paligemma-3b": "paligemma_3b",
    "llama3-405b": "llama3_405b",
    "mamba2-780m": "mamba2_780m",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def applicable(cfg: ModelConfig, shape: InputShape, *,
               allow_swa_variant: bool = True) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable, and the variant note.

    ``long_500k`` needs sub-quadratic decode state: native for SSM /
    hybrid-with-window; dense/MoE/VLM archs run the sliding-window
    variant (window=4096) when ``allow_swa_variant``; whisper's encoder
    is capped at 1500 frames so a 500k KV is architecturally
    meaningless -> skipped (see DESIGN.md).
    """
    if shape.name != "long_500k":
        return True, "native"
    if cfg.family == "encdec":
        return False, "skip: enc-dec (whisper) has no 500k-token decode"
    if cfg.sub_quadratic:
        return True, "native"
    if allow_swa_variant:
        return True, "swa(window=4096)"
    return False, "skip: full attention is quadratic at 500k"


def shape_variant(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Config actually lowered for (arch, shape) — applies the SWA
    variant for quadratic archs on long_500k."""
    ok, note = applicable(cfg, shape)
    if not ok:
        raise ValueError(note)
    if note.startswith("swa"):
        return cfg.replace(window=4096)
    return cfg
