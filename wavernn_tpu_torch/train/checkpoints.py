"""Vocoder and Tacotron checkpoints (port of
``wavernn_tpu.train.checkpoints``; reference utils/checkpoints.py:6-132).

The same scheme: paired weights/optimizer files, an always-rewritten
"latest" pair plus optional named snapshots, broken-pair detection, and
create-if-missing with a warm start. The files are the JAX package's own
flat ``.npz`` archives, so either package resumes the other's run:

- weights: ``params/<JAX key>`` (compat/to_jax.py), ``meta/step`` and, for
  the Tacotron, ``meta/r``;
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

from ..compat.from_jax import tacotron_state_dict, wavernn_state_dict
from ..compat.to_jax import (from_jax_array, jax_flat_from_state_dict,
                             tacotron_jax_key, to_jax_array, wavernn_jax_key)

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


def _key_fn(model):
    """The state-dict -> JAX key map of a WaveRNN or a Tacotron."""
    return tacotron_jax_key if hasattr(model, "decoder") else wavernn_jax_key


def optimizer_flat(model, optimizer) -> Dict[str, np.ndarray]:
    """Adam's count and moments under the JAX package's flat keys."""
    prefix = _opt_prefix(optimizer.clip_grad_norm is not None)
    params = dict(model.named_parameters())
    key_fn = _key_fn(model)
    count = 0
    flat = {}
    for name, t in model.state_dict().items():
        hit = key_fn(name)
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
    key_fn = _key_fn(model)
    for name, p in model.named_parameters():
        key, transpose = key_fn(name)
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


def read_weights(path, model=None) -> Tuple[dict, int]:
    """(state dict, step) from a weights ``.npz`` of either package or a
    reference PyTorch checkpoint. ``model``: a Tacotron's ``.npz`` needs
    it for its stop threshold (a WaveRNN's needs nothing)."""
    path = Path(path)
    if path.suffix in TORCH_SUFFIXES:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return sd, int(sd["step"].reshape(-1)[0]) if "step" in sd else 0
    flat = load_flat(path)
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    step = int(flat.get("meta/step", 0))
    if "rnn1/wi" in params:
        return wavernn_state_dict(params, step), step
    r = int(flat["meta/r"]) if "meta/r" in flat else int(model.decoder.r)
    return tacotron_state_dict(params, float(model.stop_threshold), step,
                               r), step


def _paths(model_name: str, workspace):
    if model_name == "voc":
        return (workspace.voc_latest_weights, workspace.voc_latest_optim,
                workspace.get_voc_named_weights,
                workspace.get_voc_named_optim)
    if model_name == "tts":
        return (workspace.tts_latest_weights, workspace.tts_latest_optim,
                workspace.get_tts_named_weights,
                workspace.get_tts_named_optim)
    raise ValueError(model_name)


def save_checkpoint(model_name: str, workspace, model, optimizer, step: int,
                    name: Optional[str] = None, log=print,
                    r: Optional[int] = None) -> None:
    """Save the latest pair (always) and a named snapshot when ``name`` is
    given (checkpoints.py:29-76); ``r``, the Tacotron's reduction factor,
    goes to ``meta/r``."""
    w_path, o_path, named_w, named_o = _paths(model_name, workspace)
    weights = {f"params/{k}": v for k, v in jax_flat_from_state_dict(
        model.state_dict(), _key_fn(model)).items()}
    weights["meta/step"] = np.asarray(step)
    if r is not None:
        weights["meta/r"] = np.asarray(r)
    optim = optimizer_flat(model, optimizer)
    save_flat(w_path, weights)
    save_flat(o_path, optim)
    if name is not None:
        save_flat(named_w(name), weights)
        save_flat(named_o(name), optim)
        log(f"Saved checkpoint {name}")


def restore_checkpoint(model_name: str, workspace, model, optimizer,
                       create_if_missing: bool = False,
                       init_weights_path: Optional[str] = None,
                       log=print) -> int:
    """Restore the latest pair into ``model`` and ``optimizer`` in place and
    return its step; optionally create it, warm-started from
    ``init_weights_path`` with the step reset (checkpoints.py:79-132)."""
    w_path, o_path, _, _ = _paths(model_name, workspace)
    w_exists, o_exists = w_path.exists(), o_path.exists()
    if w_exists != o_exists:
        raise FileNotFoundError(
            f"Broken checkpoint pair: one of {w_path} / {o_path} is missing")
    if not w_exists:
        if not create_if_missing:
            raise FileNotFoundError(f"No checkpoint at {w_path}")
        if init_weights_path:
            sd, _ = read_weights(init_weights_path, model)
            sd["step"] = torch.zeros_like(model.step)
            model.load_state_dict(sd, strict=True)
            log(f"Warm-started weights from {init_weights_path} (step reset)")
        save_checkpoint(model_name, workspace, model, optimizer, 0, log=log)
        return 0
    sd, step = read_weights(w_path, model)
    model.load_state_dict(sd, strict=True)
    load_optimizer_flat(model, optimizer, load_flat(o_path))
    log(f"Restored checkpoint from {w_path}")
    return step
