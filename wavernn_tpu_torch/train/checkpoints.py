"""Vocoder checkpoints (port of ``wavernn_tpu.train.checkpoints``; reference
utils/checkpoints.py:6-132).

The same scheme: paired weights/optimizer files, an always-rewritten
"latest" pair plus optional named snapshots, broken-pair detection, and
create-if-missing with a warm start. The files are the JAX package's own
flat ``.npz`` archives, so either package resumes the other's run:

- weights: ``params/<JAX key>`` (compat/to_jax.py) and ``meta/step``;
- optimizer: the flat keys of ``tree_to_flat({"opt": state})`` for optax's
  ``chain(clip_by_global_norm, adam)``: ``opt/1/0/.count`` (int32) and
  ``opt/1/0/.mu/<JAX key>``, ``opt/1/0/.nu/<JAX key>`` (``opt/0/0/...``
  without the clip, whose state holds no arrays).

JAX keeps BatchNorm's running mean and variance inside its parameters, so
its Adam state holds (always zero) moments for them. The port writes those
zero entries and drops them on reading.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..compat.from_jax import wavernn_state_dict
from ..compat.to_jax import (from_jax_array, jax_flat_from_state_dict,
                             to_jax_array, wavernn_jax_key)

TORCH_SUFFIXES = (".pyt", ".pt", ".pth")


def save_flat(path, flat: Dict[str, np.ndarray]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path), **flat)


def load_flat(path) -> Dict[str, np.ndarray]:
    with np.load(str(path)) as z:
        return {k: z[k] for k in z.files}


def _opt_prefix(clip: bool) -> str:
    # chain(clip, adam): the clip's state is empty, adam = chain(
    # scale_by_adam, scale_by_learning_rate) -> its moments at (1, 0)
    return "opt/1/0/" if clip else "opt/0/0/"


def optimizer_flat(model, optimizer) -> Dict[str, np.ndarray]:
    """Adam's count and moments under the JAX package's flat keys."""
    prefix = _opt_prefix(optimizer.clip_grad_norm is not None)
    params = dict(model.named_parameters())
    count = 0
    flat = {}
    for name, t in model.state_dict().items():
        hit = wavernn_jax_key(name)
        if hit is None:
            continue
        key, transpose = hit
        st = optimizer.adam.state.get(params[name]) if name in params else None
        if st:
            count = int(st["step"])
            mu, nu = st["exp_avg"], st["exp_avg_sq"]
        else:                    # not stepped yet, or a BatchNorm statistic
            mu = nu = torch.zeros_like(t, dtype=torch.float32)
        flat[f"{prefix}.mu/{key}"] = to_jax_array(mu, transpose)
        flat[f"{prefix}.nu/{key}"] = to_jax_array(nu, transpose)
    flat[f"{prefix}.count"] = np.asarray(count, np.int32)
    return flat


def load_optimizer_flat(model, optimizer, flat) -> int:
    """Set Adam's moments and count from the flat keys (either chain
    layout); returns the count. BatchNorm statistics' entries are dropped."""
    counts = [k for k in flat if k.endswith("/.count")]
    if len(counts) != 1:
        raise KeyError(f"optimizer file holds {len(counts)} Adam counts")
    prefix = counts[0][:-len(".count")]
    count = int(flat[counts[0]])
    for name, p in model.named_parameters():
        key, transpose = wavernn_jax_key(name)
        mu, nu = (from_jax_array(flat[f"{prefix}.{m}/{key}"], transpose)
                  for m in ("mu", "nu"))
        if tuple(mu.shape) != tuple(p.shape):
            raise ValueError(f"Adam moment of {name}: shape {tuple(mu.shape)}"
                             f" vs {tuple(p.shape)}")
        optimizer.adam.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.to(p.device, p.dtype),
            "exp_avg_sq": nu.to(p.device, p.dtype)}
    return count


def read_weights(path) -> Tuple[dict, int]:
    """(WaveRNN state dict, step) from a weights ``.npz`` of either package
    or a reference PyTorch checkpoint."""
    path = Path(path)
    if path.suffix in TORCH_SUFFIXES:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return sd, int(sd["step"].reshape(-1)[0]) if "step" in sd else 0
    flat = load_flat(path)
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    step = int(flat.get("meta/step", 0))
    return wavernn_state_dict(params, step), step


def _paths(model_name: str, workspace):
    if model_name != "voc":
        raise ValueError(f"only vocoder checkpoints are ported, not "
                         f"{model_name!r}")
    return workspace.voc_latest_weights, workspace.voc_latest_optim


def save_checkpoint(model_name: str, workspace, model, optimizer, step: int,
                    name: Optional[str] = None, log=print) -> None:
    """Save the latest pair (always) and a named snapshot when ``name`` is
    given (checkpoints.py:29-76)."""
    w_path, o_path = _paths(model_name, workspace)
    weights = {f"params/{k}": v
               for k, v in jax_flat_from_state_dict(model.state_dict()).items()}
    weights["meta/step"] = np.asarray(step)
    optim = optimizer_flat(model, optimizer)
    save_flat(w_path, weights)
    save_flat(o_path, optim)
    if name is not None:
        save_flat(workspace.get_voc_named_weights(name), weights)
        save_flat(workspace.get_voc_named_optim(name), optim)
        log(f"Saved checkpoint {name}")


def restore_checkpoint(model_name: str, workspace, model, optimizer,
                       create_if_missing: bool = False,
                       init_weights_path: Optional[str] = None,
                       log=print) -> int:
    """Restore the latest pair into ``model`` and ``optimizer`` in place and
    return its step; optionally create it, warm-started from
    ``init_weights_path`` with the step reset (checkpoints.py:79-132)."""
    w_path, o_path = _paths(model_name, workspace)
    w_exists, o_exists = w_path.exists(), o_path.exists()
    if w_exists != o_exists:
        raise FileNotFoundError(
            f"Broken checkpoint pair: one of {w_path} / {o_path} is missing")
    if not w_exists:
        if not create_if_missing:
            raise FileNotFoundError(f"No checkpoint at {w_path}")
        if init_weights_path:
            sd, _ = read_weights(init_weights_path)
            sd["step"] = torch.zeros_like(model.step)
            model.load_state_dict(sd, strict=True)
            log(f"Warm-started weights from {init_weights_path} (step reset)")
        save_checkpoint(model_name, workspace, model, optimizer, 0, log=log)
        return 0
    sd, step = read_weights(w_path)
    model.load_state_dict(sd, strict=True)
    load_optimizer_flat(model, optimizer, load_flat(o_path))
    log(f"Restored checkpoint from {w_path}")
    return step
