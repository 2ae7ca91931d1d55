"""Device probes shared by the kernel wrappers and the ``ops`` dispatch.

The ONE definition of "are we on the card the kernels were written
for" (``on_hopper``) and of how an entry point turns its ``device``
argument into a ``torch.device`` (``resolve_device``): the card by
default, the CPU only when the caller asks for it, and a clear error
when the card is asked for and absent — never a quiet fall back.

``row_scaled_error`` and ``ATTN_BF16_ROW_TOL`` are how an attention
kernel's bf16 output is held against its f32 plain version, on the card
(``chip_smoke.py``) and in the emulations of the tests.

Float32 matrix products stay full float32 on the card: PyTorch's own
default, stated and set here once so that no other setting can leak
TF32 (about three decimal digits) into the reference-parity path.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

__all__ = ["HOPPER_CAPABILITY", "on_hopper", "is_hopper", "resolve_device",
           "synchronize", "check_kernel_tensors", "row_scaled_error",
           "ATTN_BF16_ROW_TOL"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HOPPER_CAPABILITY = (9, 0)

# the limit of ``row_scaled_error`` for a bf16 attention output against
# its plain version: 4 x bf16's unit roundoff (2^-8), two bf16 ulps at
# the row's largest output.  The kernel's own error before it rounds
# stays under one ulp (the tensor-core flash body's bf16 weights: under
# 0.006 of the row's largest at the card's long shapes in
# tests/test_torch_attention_hopper.py), so a kernel and a plain version
# that both round to bf16 differ by one ulp at most, 2^-7, what the card
# shows; a dropped key tile, or a span dropped or merged unscaled,
# moves a row by 0.2 of its largest output or more, so it fails, where
# an absolute limit of 3e-2 passes a dropped span on the long decode's
# outputs of about 0.02.
ATTN_BF16_ROW_TOL = 2.0 ** -6


def row_scaled_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (the last dimension: one query row of
    one head) relative to the largest |want| of that row; a row whose
    ``want`` is all zero (an empty decode slot) counts its absolute
    error.  Attention outputs shrink as 1/sqrt(keys), so one limit
    relative to each row holds a short row and a long one alike."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    return (err / torch.where(scale > 0, scale, 1.0)).max().item()


def is_hopper(device: torch.device | int | None = None) -> bool:
    """True when ``device`` (default: the current CUDA device) is sm_90."""
    return torch.cuda.get_device_capability(device) == HOPPER_CAPABILITY


def on_hopper() -> bool:
    """True when CUDA is present and the current device is sm_90."""
    return torch.cuda.is_available() and is_hopper()


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for
    (the default of every entry point) and not available."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default) needs CUDA, but "
            f"torch.cuda.is_available() is False; pass device='cpu' to "
            f"run the plain PyTorch path on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU): a host clock
    read without it times the enqueue, not the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_kernel_tensors(what: str, tensors: dict, *, dtypes,
                         align: bool, device: torch.device | None = None
                         ) -> None:
    """The checks every attention kernel wrapper makes before a launch:
    CUDA tensors on one sm_90 card (``device``, default the first
    tensor's), a dtype the kernel was compiled for, a contiguous last
    dimension, and with ``align`` a 16-byte aligned start and strides
    that are multiples of 4 elements (the kernel's vector loads).
    Raises on the first tensor that fails; a DTensor (a sharded step)
    fails first: ``kernels.ops`` hands a kernel its local shards
    through ``local_map``, and a kernel reads ``data_ptr()``."""
    for name, t in tensors.items():
        if isinstance(t, DTensor):
            raise TypeError(f"the CUDA {what} kernel got a DTensor for "
                            f"{name}; call it through kernels.ops, which "
                            f"passes each rank's local tensor")
    dev = device or next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA {what} kernel needs a CUDA tensor, "
                             f"got {name} on {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
    if not is_hopper(dev):
        raise RuntimeError(
            f"the {what} kernel is built for sm_90a; "
            f"{torch.cuda.get_device_name(dev)} has capability "
            f"{torch.cuda.get_device_capability(dev)}")
    for name, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be one of "
                            f"{sorted(str(d) for d in dtypes)}, got {t.dtype}")
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{what}: {name}'s last dimension must be "
                             f"contiguous, got strides {t.stride()}")
        if align and (t.data_ptr() % 16
                      or any(s % 4 for s in t.stride()[:-1])):
            raise ValueError(f"{what}: {name} must start 16-byte aligned "
                             f"with strides that are multiples of 4 "
                             f"elements, got strides {t.stride()}")
