"""The classifier's training step and loop, ported from the classifier
half of ``repro.training.train_loop``.

The model carries its config and holds its parameters, so the step
updates the module in place where the reference returns new params:
``train_step(model, opt_state, tokens, labels) -> (opt_state,
metrics)``.  The port's parameters are frozen (``models.nn.param``);
the step turns gradients on for its own forward and backward only, so
the model serves under ``inference_mode`` as before.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.distilbert import DistilBERT
from repro_torch.training.optimizer import AdamW, AdamWState


def make_classifier_train_step(opt: AdamW) -> Callable:
    """Train step for the DistilBERT classifier: joint loss over the
    full head and the early-exit proxy head at its default depth (2
    layers), ``ce + 0.5 * ce_exit`` (so the proxy is a *calibrated*
    triage signal, not an afterthought)."""

    def train_step(model: DistilBERT, opt_state: AdamWState,
                   tokens: torch.Tensor, labels: torch.Tensor):
        params = dict(model.named_parameters())
        try:
            with torch.enable_grad():
                for p in params.values():
                    p.requires_grad_(True)
                ce = F.cross_entropy(model.logits(tokens), labels)
                ce_exit = F.cross_entropy(model.early_exit_logits(tokens),
                                          labels)
                grads = torch.autograd.grad(ce + 0.5 * ce_exit,
                                            list(params.values()))
        finally:
            for p in params.values():
                p.requires_grad_(False)
        new_p, opt_state, gnorm = opt.update(dict(zip(params, grads)),
                                             opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        return opt_state, {"ce": ce.detach(), "ce_exit": ce_exit.detach(),
                           "grad_norm": gnorm}

    return train_step


def train_classifier(model: DistilBERT, batches, *, steps: int,
                     opt: AdamW | None = None, log_every: int = 50,
                     verbose: bool = True, device="cuda"):
    """Train ``model`` in place on ``device`` (the card by default) over
    ``steps`` numpy (tokens, labels) batches; -> (model, log), the log
    the reference's records (``ce``, ``ce_exit``, ``grad_norm``,
    ``step``) every ``log_every`` steps and at the last."""
    dev = resolve_device(device)
    model = model.to(dev)
    opt = opt or AdamW(lr=1e-3, weight_decay=0.0)
    step_fn = make_classifier_train_step(opt)
    opt_state = opt.init(dict(model.named_parameters()))
    log = []
    for i in range(steps):
        toks, labels = next(batches)
        opt_state, m = step_fn(model, opt_state,
                               torch.from_numpy(toks).long().to(dev),
                               torch.from_numpy(labels).long().to(dev))
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec["step"] = i
            log.append(rec)
            if verbose:
                print(f"step {i:5d}  ce {rec['ce']:.4f}  "
                      f"exit {rec['ce_exit']:.4f}")
    return model.eval(), log
