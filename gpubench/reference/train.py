"""Plain attention-forcing (offline) training steps of the Tacotron: the
loss of ``tacotron.af_forward``, its gradients by autograd, optax's
global-norm clip and Adam (b1 0.9, b2 0.999, eps 1e-8), in float32."""
from __future__ import annotations

import torch

from .tacotron import af_forward

# state-dict entries that are not trained
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
_NOT_TRAINED = ("step", "decoder.r", "stop_threshold")


def trained(name: str) -> bool:
    return not (name.endswith(_BUFFERS) or name in _NOT_TRAINED)


def af_loss(P, batch, cfg):
    """mean |mel - m| + mean |linear - m| + coeff * mean |attn - aref|."""
    mel, lin, attn = af_forward(P, batch["ids"], batch["mel"], batch["aref"],
                                batch["masks"], cfg)
    m = batch["mel"]
    return (torch.mean(torch.abs(mel - m)) + torch.mean(torch.abs(lin - m))
            + cfg["attn_loss_coeff"] * torch.mean(torch.abs(attn
                                                            - batch["aref"])))


def steps(P0, batches, cfg):
    """Adam steps from the weights P0, one a batch: (the losses, each
    trained leaf's norm of the first step's clipped gradient, each leaf's
    norm of the change over all the steps)."""
    names = [k for k in P0 if trained(k)]
    params = {k: P0[k].detach().clone().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in P0.items() if not trained(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, clip = cfg["tts_lr"], cfg["tts_clip_grad_norm"]
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        loss = af_loss({**fixed, **params}, batch, cfg)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = v[k] / (1 - b2 ** t)
                params[k].sub_(lr * mh / (torch.sqrt(vh) + eps))
            if first is None:
                first = {k: float(torch.linalg.vector_norm(m[k]) / (1 - b1))
                         for k in names}
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - P0[k]))
              for k in names}
    return losses, first, change
