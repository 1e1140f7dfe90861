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
from ..device import resolve_device
from ..parallel import mesh as pm
from ..paths import Workspace
from ..train.checkpoints import TORCH_SUFFIXES, restore_checkpoint


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


def join_ranks(force_cpu: bool, global_batch: int):
    """(this rank's device, the data-parallel mesh) of a training CLI: one
    process per GPU under ``torchrun`` (``scripts/torchrun_train.sh``),
    NCCL between the cards, gloo with --force_cpu; a single process gets
    its one device and no mesh. The global batch must divide by the world
    size (``parallel/mesh.training_mesh``)."""
    device = resolve_device("cpu" if force_cpu else "cuda")
    device = pm.initialize_distributed(device)
    return device, pm.training_mesh(global_batch)


def shards(mesh) -> Tuple[int, int]:
    """(num_shards, shard_index) the batchers take for ``mesh``."""
    return (1, 0) if mesh is None else (pm.size(mesh), pm.rank(mesh))


def devices_line(mesh, device) -> str:
    """The CLIs' device line: ranks, each a process with one device."""
    n = shards(mesh)[0]
    return f"{n} data-parallel x {n} rank(s), one {device.type} device each"


def restore_on_ranks(model_name: str, ws, model, optimizer, mesh,
                     init_weights_path=None) -> int:
    """``restore_checkpoint`` on every rank: rank 0 first creates the pair
    of a fresh run; then every rank reads the same files, so the ranks
    start from one state, optimizer moments included."""
    if mesh is None or pm.rank(mesh) == 0:
        step = restore_checkpoint(model_name, ws, model, optimizer,
                                  create_if_missing=True,
                                  init_weights_path=init_weights_path)
    if mesh is None:
        return step
    pm.barrier(mesh)
    return restore_checkpoint(model_name, ws, model, optimizer,
                              log=lambda *a: None)
