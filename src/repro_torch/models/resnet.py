"""ResNet-18 (paper model #2, He et al. 2016), ported from
``repro.models.resnet``.

Images ``[B, H, W, 3]`` in, logits ``[B, n_classes]`` out, as the
reference; inside it runs NCHW on ``F.conv2d`` (cuDNN on the card: the
reference's convolutions are ``lax.conv_general_dilated``, outside any
Pallas kernel).  Batch-norm is inference-mode, folded into scale and
bias.  Convolution weights are OIHW where the reference's are HWIO
(``models.convert.resnet_from_numpy`` transposes them); the
``state_dict`` keys are the reference's flat keys with ``.`` for ``/``.

JAX's ``"SAME"`` padding puts the odd pixel after: at stride 2 on an
even input the 7x7 stem pads 2 before and 3 after, a 3x3 convolution 0
and 1.  PyTorch's ``padding="same"`` refuses a stride above 1, so the
pads are computed here, and the max-pool pads with ``-inf``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.nn import dense_init_, param

STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) of XLA's ``"SAME"`` padding along one axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int) -> tuple[int, ...]:
    (t, b), (l, r) = (same_pads(x.shape[-2], k, stride),
                      same_pads(x.shape[-1], k, stride))
    return l, r, t, b


def conv_same(x: torch.Tensor, w: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """NCHW x OIHW convolution with ``"SAME"`` padding."""
    l, r, t, b = _pads(x, w.shape[-1], stride)
    if (l, t) == (r, b):
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``reduce_window(max, -inf, "SAME")``."""
    return F.max_pool2d(F.pad(x, _pads(x, k, stride), value=-math.inf),
                        k, stride)


def _conv_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)


class BatchNorm(nn.Module):
    """Inference-mode batch-norm, the running statistics folded into
    ``scale`` and ``bias`` (ones / zeros at init)."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        self.scale = param(c, device=device)
        self.bias = param(c, device=device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class Stem(nn.Module):
    def __init__(self, *, device=None):
        super().__init__()
        self.conv = param(64, 3, 7, 7, device=device)
        self.bn = BatchNorm(64, device=device)


class Block(nn.Module):
    """Basic block; a 1x1 projection on the shortcut where the stride or
    the width changes."""

    def __init__(self, cin: int, cout: int, stride: int, *, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = param(cout, cin, 3, 3, device=device)
        self.bn1 = BatchNorm(cout, device=device)
        self.conv2 = param(cout, cout, 3, 3, device=device)
        self.bn2 = BatchNorm(cout, device=device)
        self.proj = None
        if stride != 1 or cin != cout:
            self.proj = param(cout, cin, 1, 1, device=device)
            self.proj_bn = BatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv_same(x, self.conv1, self.stride)))
        y = self.bn2(conv_same(y, self.conv2))
        sc = x
        if self.proj is not None:
            sc = self.proj_bn(conv_same(x, self.proj, self.stride))
        return F.relu(y + sc)


class ResNet18(nn.Module):
    """Parameters are allocated uninitialised; :func:`init` fills them
    from a seed and ``models.convert`` from reference weights."""

    def __init__(self, n_classes: int = 1000, *, device=None):
        super().__init__()
        self.stem = Stem(device=device)
        stages, cin = [], 64
        for cout, blocks, stride in STAGES:
            stages.append(nn.ModuleList(
                Block(cin if b == 0 else cout, cout,
                      stride if b == 0 else 1, device=device)
                for b in range(blocks)))
            cin = cout
        self.stages = nn.ModuleList(stages)
        self.fc = param(512, n_classes, device=device)
        self.fc_b = param(n_classes, device=device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            if p.dim() == 4:
                _conv_init_(p, gen)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()
        dense_init_(self.fc, gen)
        with torch.no_grad():
            self.fc_b.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> logits [B, n_classes]."""
        x = conv_same(images.permute(0, 3, 1, 2), self.stem.conv, stride=2)
        x = max_pool_same(F.relu(self.stem.bn(x)))
        for stage in self.stages:
            for blk in stage:
                x = blk(x)
        return x.mean(dim=(2, 3)) @ self.fc + self.fc_b


def init(n_classes: int = 1000, *, seed: int = 0,
         device="cuda") -> ResNet18:
    """A ResNet-18 with weights drawn from ``torch.Generator(seed)`` on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    model = ResNet18(n_classes, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
