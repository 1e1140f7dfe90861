"""Shared CLI plumbing for the port: config, workspace and weight loading.

Weights load from a reference PyTorch checkpoint (``.pyt``/``.pt``/
``.pth``: ``torch.load`` then ``load_state_dict``) or from the JAX
trainer's ``.npz`` (flat ``params/...`` keys and ``meta/step``,
``meta/r``; train/checkpoints.py:30-57) through the weight bridge.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..compat.from_jax import state_dict_from_jax
from ..config import Config
from ..models.tacotron import Tacotron
from ..models.wavernn import WaveRNN
from ..paths import Workspace
from ..train.checkpoints import TORCH_SUFFIXES


def load_config(hp_file: Optional[str]) -> Config:
    if hp_file and Path(hp_file).exists():
        return Config.from_hparams_file(hp_file)
    return Config()


def make_workspace(cfg: Config, output_root: str = ".") -> Workspace:
    return Workspace(cfg.data_path, cfg.voc_model_id, cfg.tts_model_id,
                     ignore_voc=cfg.ignore_voc, ignore_tts=cfg.ignore_tts,
                     output_root=output_root)


def _read(path: Path, cfg: Config):
    """(state dict, npz meta) from either checkpoint format."""
    if path.suffix in TORCH_SUFFIXES:
        return torch.load(path, map_location="cpu", weights_only=True), {}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    meta = {k[len("meta/"):]: v for k, v in flat.items()
            if k.startswith("meta/")}
    step = int(meta.get("step", 0))
    r = int(meta["r"]) if "r" in meta else 1
    return state_dict_from_jax(params, cfg, step=step, r=r), meta


def load_voc_model(path, cfg: Config, device) -> Tuple[WaveRNN, int]:
    """WaveRNN on ``device`` and its training step."""
    sd, _ = _read(Path(path), cfg)
    model = WaveRNN(cfg.voc, cfg.dsp)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval(), int(model.step.reshape(-1)[0])


def load_tts_model(path, cfg: Config, device) -> Tuple[Tacotron, int, int]:
    """Tacotron on ``device``, its training step and reduction factor r."""
    path = Path(path)
    sd, meta = _read(path, cfg)
    if path.suffix not in TORCH_SUFFIXES and "r" not in meta:
        raise ValueError(f"{path} holds no meta/r: the reduction factor "
                         "the decoder was trained with is unknown")
    model = Tacotron(cfg.tts, cfg.dsp.num_mels)
    model.load_state_dict(sd, strict=True)
    return (model.to(device).eval(), int(model.step.reshape(-1)[0]),
            int(model.decoder.r))


def sparse_pack_or_dense(voc: WaveRNN, cfg: Config):
    """``--sparse``: pack the vocoder's zero-block pattern once after
    loading (ops/cuda_gen.pack_sparse); says so when nothing packs, and the
    vocoder is then served dense (the JAX CLIs' message)."""
    from ..ops.cuda_gen import pack_sparse
    packed = pack_sparse(voc.core_weights(), cfg.voc)
    if not packed.entries:
        print("| --sparse: no (128,128)-block-sparse matrices found in the "
              "checkpoint; serving dense")
    return packed
