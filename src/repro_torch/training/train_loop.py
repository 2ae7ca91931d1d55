"""Training steps and the classifier's loop, ported from
``repro.training.train_loop``.

The model carries its config and holds its parameters, so a step
updates the module in place (``AdamW.update_``) where the reference
returns new params: ``train_step(model, opt_state, batch) -> (opt_state,
metrics)`` for the LM, ``train_step(model, opt_state, tokens, labels)``
for the classifier.  The port's parameters are frozen
(``models.nn.param``); a step turns gradients on for its own forward
and backward only, so the model serves under ``inference_mode`` as
before.  The LM step's forward takes the einsum and chunked paths, not
the kernels (``models.transformer``: no kernel has a backward, and the
reference differentiates those paths too), and remats each layer as
``cfg.remat`` / ``cfg.remat_policy`` say.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.distilbert import DistilBERT
from repro_torch.models.transformer import LM
from repro_torch.training.optimizer import AdamW, AdamWState, cosine_schedule


def _grads(model: torch.nn.Module, loss_fn: Callable):
    """(loss_fn()'s outputs, {name: gradient}) with the model's frozen
    parameters requiring grad for this forward and backward only;
    ``loss_fn`` returns (the loss to differentiate, anything)."""
    params = dict(model.named_parameters())
    try:
        with torch.enable_grad():
            for p in params.values():
                p.requires_grad_(True)
            loss, extra = loss_fn()
            grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return (loss.detach(), extra), params, dict(zip(params, grads))


def lm_loss(model: LM, tokens: torch.Tensor, *, prefix_embeds=None,
            enc_embeds=None):
    """Next-token cross-entropy (tokens [B, S+1]) in f32 + the MoE aux
    loss times ``cfg.router_aux_weight``; -> (total, {"loss", "aux"})."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:].long()
    logits, aux = model(inp, prefix_embeds=prefix_embeds,
                        enc_embeds=enc_embeds)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()
    total = loss + model.cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def make_train_step(opt: AdamW, *, total_steps: int = 10_000,
                    warmup: int = 100) -> Callable:
    """-> ``train_step(model, opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` is a dict: {"tokens": [B, S+1]} plus "prefix_embeds" /
    "enc_embeds" for a prefix-LM or an encoder-decoder.  The learning
    rate scales by the cosine schedule at the count before the step, as
    the reference's; the metrics are ``loss``, ``aux``, ``total``,
    ``grad_norm`` (before clipping) and ``lr_scale``."""

    def train_step(model: LM, opt_state: AdamWState, batch: dict):
        (total, metrics), params, grads = _grads(model, lambda: lm_loss(
            model, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
            enc_embeds=batch.get("enc_embeds")))
        lr_scale = cosine_schedule(opt_state.count, warmup=warmup,
                                   total=total_steps).to(total.device)
        opt_state, gnorm = opt.update_(grads, opt_state, params,
                                       lr_scale=lr_scale)
        return opt_state, {"loss": metrics["loss"].detach(),
                           "aux": metrics["aux"].detach(), "total": total,
                           "grad_norm": gnorm, "lr_scale": lr_scale}

    return train_step


def make_classifier_train_step(opt: AdamW) -> Callable:
    """Train step for the DistilBERT classifier: joint loss over the
    full head and the early-exit proxy head at its default depth (2
    layers), ``ce + 0.5 * ce_exit`` (so the proxy is a *calibrated*
    triage signal, not an afterthought)."""

    def train_step(model: DistilBERT, opt_state: AdamWState,
                   tokens: torch.Tensor, labels: torch.Tensor):
        def loss_fn():
            ce = F.cross_entropy(model.logits(tokens), labels)
            ce_exit = F.cross_entropy(model.early_exit_logits(tokens),
                                      labels)
            return ce + 0.5 * ce_exit, (ce.detach(), ce_exit.detach())

        (_, (ce, ce_exit)), params, grads = _grads(model, loss_fn)
        opt_state, gnorm = opt.update_(grads, opt_state, params)
        return opt_state, {"ce": ce, "ce_exit": ce_exit, "grad_norm": gnorm}

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
