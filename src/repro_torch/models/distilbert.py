"""DistilBERT-style encoder classifier (paper model #1, arXiv:1910.01108),
ported from ``repro.models.distilbert``.

Post-LN transformer encoder with learned positions, [CLS] pooling and a
2-way head (SST-2), plus the early-exit proxy head the closed-loop
controller uses to triage requests cheaply.  ``config()`` keeps the
full-width defaults (6 layers, d 768, 12 heads, ff 3072, vocab 30522).

The module's ``state_dict`` keys are the reference's flat checkpoint
keys with ``.`` for ``/`` (``layers.0.mix.wq`` = ``layers/0/mix/wq``),
and every weight keeps the reference's shape; ``models.convert`` loads
reference weights on that correspondence.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.nn import (MLP, LayerNorm, dense_init_, embed_init_,
                                   param)


def config(n_layers=6, d_model=768, n_heads=12, d_ff=3072, vocab=30522,
           max_pos=512, n_classes=2):
    return dict(n_layers=n_layers, d_model=d_model, n_heads=n_heads,
                d_ff=d_ff, vocab=vocab, max_pos=max_pos,
                n_classes=n_classes, head_dim=d_model // n_heads)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: dict, *, device=None):
        super().__init__()
        d = cfg["d_model"]
        self.n_heads, self.head_dim = cfg["n_heads"], cfg["head_dim"]
        self.mix = attn.AttnParams(d, cfg["n_heads"], cfg["n_heads"],
                                   cfg["head_dim"], bias=True, device=device)
        self.norm1 = LayerNorm(d, device=device)
        self.mlp = MLP(d, cfg["d_ff"], device=device)
        self.norm2 = LayerNorm(d, device=device)

    def forward(self, h: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
        q, k, v = attn.project_qkv(self.mix, h, self.n_heads, self.n_heads,
                                   self.head_dim)
        o = attn.attend(q, k, v, bias)
        h = self.norm1(h + attn.out_proj(self.mix, o))
        return self.norm2(h + self.mlp(h))


class DistilBERT(nn.Module):
    """Parameters are allocated uninitialised; :func:`init` fills them
    from a seed and ``models.convert`` from reference weights."""

    def __init__(self, cfg: dict, *, device=None):
        super().__init__()
        self.cfg = dict(cfg)
        d, c = cfg["d_model"], cfg["n_classes"]
        self.emb = param(cfg["vocab"], d, device=device)
        self.pos = param(cfg["max_pos"], d, device=device)
        self.emb_norm = LayerNorm(d, device=device)
        self.cls = param(d, c, device=device)
        self.cls_b = param(c, device=device)
        # early-exit proxy head (controller's cheap L(x) source)
        self.exit_cls = param(d, c, device=device)
        self.exit_b = param(c, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device=device)
                                    for _ in range(cfg["n_layers"]))

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_init_(self.emb, gen)
        with torch.no_grad():
            self.pos.normal_(0.0, 0.02, generator=gen)
            self.cls_b.zero_()
            self.exit_b.zero_()
        self.emb_norm.reset_parameters()
        dense_init_(self.cls, gen)
        dense_init_(self.exit_cls, gen)
        for layer in self.layers:
            layer.mix.reset_parameters(gen)
            layer.norm1.reset_parameters()
            layer.mlp.reset_parameters(gen)
            layer.norm2.reset_parameters()

    def encode(self, tokens: torch.Tensor,
               pad_mask: torch.Tensor | None = None, *,
               n_layers: int | None = None) -> torch.Tensor:
        """tokens [B,S] -> hidden [B,S,D]; ``n_layers`` truncates (early
        exit).  ``pad_mask`` [B,S] bool marks real tokens (None: all)."""
        S = tokens.shape[1]
        bias = None
        if pad_mask is not None:
            bias = torch.where(pad_mask[:, None, None, None, :], 0.0,
                               attn.NEG_INF).float()
        h = self.emb[tokens] + self.pos[:S]
        h = self.emb_norm(h)
        for layer in self.layers[:n_layers]:
            h = layer(h, bias)
        return h

    def logits(self, tokens: torch.Tensor,
               pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        h = self.encode(tokens, pad_mask)
        return h[:, 0] @ self.cls + self.cls_b

    def early_exit_logits(self, tokens: torch.Tensor,
                          pad_mask: torch.Tensor | None = None,
                          exit_layer: int = 2) -> torch.Tensor:
        """Proxy-head logits after ``exit_layer`` encoder layers."""
        h = self.encode(tokens, pad_mask, n_layers=exit_layer)
        return h[:, 0] @ self.exit_cls + self.exit_b


def init(cfg: dict, *, seed: int = 0, device="cuda") -> DistilBERT:
    """A DistilBERT with weights drawn from ``torch.Generator(seed)`` on
    ``device`` (the card by default)."""
    dev = resolve_device(device)
    model = DistilBERT(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
