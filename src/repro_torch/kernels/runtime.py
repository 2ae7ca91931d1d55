"""Device probes shared by the kernel wrappers and the ``ops`` dispatch.

The ONE definition of "are we on the card the kernels were written
for" (``on_hopper``) and of how an entry point turns its ``device``
argument into a ``torch.device`` (``resolve_device``): the card by
default, the CPU only when the caller asks for it, and a clear error
when the card is asked for and absent — never a quiet fall back.

Float32 matrix products stay full float32 on the card: PyTorch's own
default, stated and set here once so that no other setting can leak
TF32 (about three decimal digits) into the reference-parity path.
"""
from __future__ import annotations

import torch

__all__ = ["HOPPER_CAPABILITY", "on_hopper", "is_hopper", "resolve_device",
           "synchronize"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HOPPER_CAPABILITY = (9, 0)


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
