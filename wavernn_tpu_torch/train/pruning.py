"""Magnitude pruning with a cubic sparsity schedule (port of
``wavernn_tpu.train.pruning``; reference ``notebooks/Pruning -
Scratchpad.ipynb`` cells 3-4: PruneMask / Pruner).

A PruneSpec names the weight matrices to prune, by reference state-dict
name, and their gate-split counts (GRU: 3, Linear: 1). Sparsity follows

    z(t) = Z * (1 - (1 - (t - t0)/S)^3)   clamped to [0, Z]

computed in float32 as the JAX package computes it, so ``k = int(n * z)``
lands on the same element. Masks are recomputed every ``prune_every``
steps from the weights' magnitudes, per gate split, and applied every step
from t0 on.

Layout: the port's weights are PyTorch's (out, in), the transpose of the
JAX package's (in, out). Gate splits run along dim 0, and a ``block``
(br, bc) keeps the JAX package's meaning: br input columns by bc output
rows. The masks equal the JAX package's, transposed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


class PruneSpec:
    """Which weights to prune: (state-dict name, n_splits) pairs, the gate
    splits along dim 0."""

    def __init__(self, entries: Sequence[Tuple[str, int]]):
        self.entries = list(entries)


def wavernn_prune_spec(prune_rnn_input: bool = True) -> PruneSpec:
    """The reference demo prunes the GRU recurrent weights and the FC
    layers, and optionally the GRU input weights."""
    entries = [("rnn1.weight_hh_l0", 3), ("rnn2.weight_hh_l0", 3),
               ("fc1.weight", 1), ("fc2.weight", 1), ("fc3.weight", 1)]
    if prune_rnn_input:
        entries = [("rnn1.weight_ih_l0", 3), ("rnn2.weight_ih_l0", 3)] \
            + entries
    return PruneSpec(entries)


def sparsity_at(t, t0: int, S: int, Z: float) -> torch.Tensor:
    """The cubic schedule (Pruner.update_sparsity) in float32: a 0-dim
    float32 tensor."""
    f32 = torch.float32
    t = torch.as_tensor(t, dtype=f32)
    y = torch.tensor(1.0, dtype=f32) - (t - torch.tensor(t0, dtype=f32)) \
        / torch.tensor(S, dtype=f32)
    Zt = torch.tensor(Z, dtype=f32)
    z = Zt * (torch.tensor(1.0, dtype=f32) - y * y * y)
    return torch.clamp(z, torch.tensor(0.0, dtype=f32), Zt)


def _kth(sorted_vals, n: int, z):
    """The threshold: element k = int(n * z) (float32 product, truncated)
    of each sorted row, clipped to [0, n - 1]."""
    k = int((torch.tensor(n, dtype=torch.float32) * z.float().cpu())
            .to(torch.int32))
    k = min(max(k, 0), n - 1)
    return sorted_vals[:, k:k + 1]


def mask_from_matrix(W, z, n_splits: int):
    """Per-gate-split magnitude mask (PruneMask.mask_from_matrix).

    W: (n_splits * h, in); zero the smallest z-fraction of each split."""
    out_dim, in_dim = W.shape
    h = out_dim // n_splits
    Wa = W.detach().abs().reshape(n_splits, h * in_dim)
    thr = _kth(torch.sort(Wa, dim=-1).values, h * in_dim, z)
    return (Wa >= thr).to(W.dtype).reshape(out_dim, in_dim)


def block_mask_from_matrix(W, z, n_splits: int, block=(8, 128)):
    """Structured magnitude pruning: zero whole blocks of ``block`` = (br
    input columns, bc output rows) by their L2 norm, per gate split.

    A block-aligned pattern is what the sample loops' sparse arm skips
    (ops/cuda_gen.pack_sparse)."""
    out_dim, in_dim = W.shape
    h = out_dim // n_splits
    br, bc = block
    assert in_dim % br == 0 and h % bc == 0, (tuple(W.shape), block)
    # (splits, h/bc, bc, in/br, br) -> block norms ordered (in/br, h/bc)
    # per split, as the JAX package orders them
    Wb = W.detach().reshape(n_splits, h // bc, bc, in_dim // br, br)
    norms = torch.sqrt(torch.sum(Wb * Wb, dim=(2, 4))).transpose(1, 2)
    flat = norms.reshape(n_splits, -1)
    thr = _kth(torch.sort(flat, dim=-1).values, flat.shape[1], z)
    keep = (flat >= thr).to(W.dtype).reshape(n_splits, in_dim // br, h // bc)
    M = keep.transpose(1, 2)[:, :, None, :, None].expand(
        n_splits, h // bc, bc, in_dim // br, br)
    return M.reshape(out_dim, in_dim)


def init_masks(params, spec: PruneSpec) -> Dict[str, torch.Tensor]:
    return {name: torch.ones_like(params[name].detach())
            for name, _ in spec.entries}


@torch.no_grad()
def update_masks(params, t, spec: PruneSpec, t0: int, S: int, Z: float,
                 block=None) -> Dict[str, torch.Tensor]:
    """All masks at sparsity z(t) (PruneMask.update_mask).

    block=None: unstructured per-element masks (the notebook's scheme);
    block=(br, bc): whole-block masks. A matrix whose output split does not
    tile by bc is masked unstructured. The leading block-divisible input
    columns get whole-block masks, and a ragged tail of input columns (rnn2's
    and fc1's, fc2's A aux inputs after their R or FC state inputs) is
    masked unstructured at the same z: the sample loops split those
    matrices at the same column."""
    z = sparsity_at(t, t0, S, Z)
    masks = {}
    for name, n_splits in spec.entries:
        W = params[name].detach()
        h = W.shape[0] // n_splits
        k = 0 if block is None or h % block[1] else \
            (W.shape[1] // block[0]) * block[0]
        if k == 0:
            masks[name] = mask_from_matrix(W, z, n_splits)
            continue
        top = block_mask_from_matrix(W[:, :k], z, n_splits, block)
        if k < W.shape[1]:
            top = torch.cat([top, mask_from_matrix(W[:, k:], z, n_splits)],
                            dim=1)
        masks[name] = top
    return masks


@torch.no_grad()
def apply_masks(params, masks, spec: Optional[PruneSpec] = None) -> None:
    """W *= M for every pruned matrix (PruneMask.apply_mask), in place: the
    weights are the model's own parameters, so every later read of them,
    the optimizer's included, sees the pruned values."""
    names = [n for n, _ in spec.entries] if spec is not None else masks
    for name in names:
        params[name].mul_(masks[name])


class Pruner:
    """Step-driven orchestration (reference Pruner): masks recomputed
    every ``prune_every`` steps after t0, applied every step from t0."""

    def __init__(self, spec: PruneSpec, start_prune: int, prune_steps: int,
                 target_sparsity: float, prune_every: int = 500, block=None):
        self.spec = spec
        self.t0 = start_prune
        self.S = prune_steps
        self.Z = target_sparsity
        self.prune_every = prune_every
        self.block = tuple(block) if block is not None else None
        self.masks = None

    def init(self, params):
        self.masks = init_masks(params, self.spec)
        return self.masks

    def _update(self, params, t: int):
        self.masks = update_masks(params, t, self.spec, self.t0, self.S,
                                  self.Z, self.block)
        return self.masks

    def masks_for_step(self, params, t: int):
        """The masks that step ``t`` applies after its optimizer update, or
        None before pruning starts. Recomputed from ``params`` (the weights
        entering step t) when t > t0 and t is a multiple of
        ``prune_every``."""
        if t < self.t0:
            return None
        if self.masks is None:
            self.init(params)
        if t > self.t0 and t % self.prune_every == 0:
            self._update(params, t)
        return self.masks

    def restart(self, params, t: int):
        """Recompute the masks after resuming from a checkpoint at step t
        (Pruner.restart)."""
        return self._update(params, t)

    def num_pruned(self) -> int:
        if self.masks is None:
            return 0
        return int(sum(float((1 - m).sum()) for m in self.masks.values()))

    def total_params(self) -> int:
        if self.masks is None:
            return 0
        return int(sum(m.numel() for m in self.masks.values()))
