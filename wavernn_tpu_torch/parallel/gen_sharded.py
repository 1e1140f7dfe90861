"""Fold-parallel generation on one device or over a mesh, with the
exact-seam mode (port of ``wavernn_tpu/parallel/gen_sharded.py``).

Crossfade mode (the reference's scheme, fatchord_version.py:293-405): the
folds run as one batch, independent after their overlap warm-up, and are
cross-faded at the end. On a mesh (a ``DeviceMesh`` with a ``"data"``
dimension, parallel/mesh.py; every rank calls with the same mels) each
rank builds the whole conditioning, runs the sample loop on its contiguous
slice of the folds, the fold count padded to a multiple of the world size
as the JAX package pads it (gen_sharded.py:344-352), and the samples are
all-gathered: every rank crossfades and returns the same wave. The
kernels' counter hash takes the slice's global rows (``row0``,
``B_global``), so the ranks draw exactly the one-device launch's numbers,
where the JAX package folds the shard index into each shard's key.

Exact-seam mode: instead of crossfading overlap regions that only nearly
match, hand the true RNN state across fold boundaries. Each refinement pass
re-runs every fold, this time starting fold i from the state fold i-1 had
when it *entered* local step ``target + overlap`` (fold i's global start).
Pass k makes the first k + 1 folds exact; ``num_folds - 1`` passes
reproduce sequential generation bit for bit, so the folds concatenate
without a crossfade. Every pass draws the same noise (injected, or the
counter hash from one seed), which is what makes the seam error fall.

On frame-rate folds the passes run B4b (``cuda_gen.generate_fused_with_
state``), otherwise B3 with its state arm (``generate_materialized``); on
CPU tensors their plain versions run. On a mesh each pass runs on the
rank's folds; the state roll stays inside a rank, and the snapshot of a
rank's last fold goes to the next rank's first (the JAX package's
collective permute, here a point-to-point send); rank 0's first fold keeps
zeros.

Output convention, the JAX package's: ``generate_sharded`` returns the
trimmed float32 samples as the loop drew them. It applies no mu-law decode
and no 20-frame tail fade (gen_sharded.py:199-211, :334, :359, :376),
unlike ``models/wavernn.generate`` / ``generate_fast``.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import resolve_device
from ..models import wavernn as wr
from ..ops.cuda_gen import (generate_fused, generate_fused_with_state,
                            generate_materialized)
from ..ops.fold import fold_with_overlap, xfade_and_unfold
from .mesh import FoldShard, same_seed, send_to_next

#: stats of the most recent crossfade-mode ``generate_sharded`` call on
#: frame-rate folds: its wall seconds and fold layout (devices, padding
#: folds, folds a shard, the share of padding)
last_stats: dict = {}


def _seam_shift(state, mesh=None):
    """Fold i receives fold i-1's boundary state; fold 0 keeps zeros. On a
    mesh the folds are this rank's: its first fold receives the previous
    rank's last fold's state (rank 0's keeps zeros)."""
    h1, h2, x = state
    R = h1.shape[1]
    if mesh is None:
        prev = h1.new_zeros(2 * R + 1)
    else:
        prev = send_to_next(torch.cat([h1[-1], h2[-1], x[-1:]]), mesh)

    def roll(s, first):
        rolled = torch.roll(s, 1, dims=0)
        rolled[0] = first
        return rolled
    return (roll(h1, prev[:R]), roll(h2, prev[R:2 * R]), roll(x, prev[2 * R]))


def _seam_refine(one_pass, seam_passes: int, mesh=None):
    """The initial pass and ``seam_passes`` state-handoff refinements.
    Returns (samples, per-pass mean-abs sample change of these folds)."""
    samples, snap = one_pass(None)
    errs = []
    for _ in range(seam_passes):
        new_samples, snap = one_pass(_seam_shift(snap, mesh))
        errs.append((new_samples - samples).abs().mean())
        samples = new_samples
    return samples, (torch.stack(errs) if errs else samples.new_zeros(0))


def generate_exact_seam(core, mels_up, aux, mode: str, target: int,
                        overlap: int, seam_passes: int = 2, noise=None,
                        seed: int = 0, compute_dtype=torch.bfloat16,
                        mesh=None, row0: int = 0,
                        B_global: Optional[int] = None):
    """Folded generation with state handoff on sample-rate conditioning
    (B3's state arm). mels_up / aux: folded (B, L, ·), L = target +
    2*overlap. noise: injected uniforms (L, B, ...), else the counter hash
    keyed by ``seed``, the same in every pass. Returns (samples (B, L),
    per-pass seam error); concatenate with ``concat_folds``. ``mesh``: the
    folds are this rank's, rows ``row0``.. of ``B_global`` (module
    docstring)."""
    boundary = target + overlap   # fold i's global start within fold i-1

    def one_pass(init_state):
        return generate_materialized(
            core, mels_up, aux, mode, noise=noise, seed=seed,
            init_state=init_state, state_snapshot_at=boundary,
            compute_dtype=compute_dtype, row0=row0, B_global=B_global)
    return _seam_refine(one_pass, seam_passes, mesh)


def generate_exact_seam_fused(core, frames, phi, hop: int, aux_tap: int,
                              fold_chunks: int, mode: str, target: int,
                              overlap: int, seam_passes: int = 2, noise=None,
                              seed: int = 0, compute_dtype=torch.bfloat16,
                              mesh=None, row0: int = 0,
                              B_global: Optional[int] = None):
    """``generate_exact_seam`` on frame-rate folds (``polyphase``'s
    layout, as ``generate_fused`` takes them), each pass one launch of
    B4b; ``mesh``, ``row0`` and ``B_global`` as there."""
    boundary = target + overlap

    def one_pass(init_state):
        return generate_fused_with_state(
            core, frames, phi, hop, aux_tap, fold_chunks, mode, noise=noise,
            seed=seed, init_state=init_state, state_snapshot_at=boundary,
            compute_dtype=compute_dtype, row0=row0, B_global=B_global)
    return _seam_refine(one_pass, seam_passes, mesh)


def concat_folds(samples, target: int, overlap: int, wave_len: int):
    """Hard (no-crossfade) unfold of exact-seam output: fold i contributes
    its local [0, target + overlap) samples at global offset
    i*(target + overlap), the last fold its tail too."""
    seg = target + overlap
    body = samples[:, :seg].reshape(-1)
    tail = samples[-1, seg:]
    return torch.cat([body, tail])[:wave_len]


@torch.no_grad()
def generate_sharded(model: wr.WaveRNN, mels, *, mesh=None,
                     target: Optional[int] = None,
                     overlap: Optional[int] = None, seam_passes: int = 0,
                     noise=None, generator: Optional[torch.Generator] = None,
                     device="cuda", device_out: bool = False,
                     sparse_packed=None):
    """Fold-batched generation of one utterance (gen_sharded.py:292-377).

    mels: (1, n_mels, T_frames) in [0, 1]. ``seam_passes`` 0: the
    crossfade of independent folds, on frame-rate folds (B1) when target
    and overlap are hop multiples, else on sample-rate folds (B3);
    ``seam_passes`` > 0: exact seams and a hard concatenation, on B4b or
    B3's state arm alike. noise: injected uniforms (fold_len, folds, ...);
    None draws the counter hash's seed from ``generator`` (rank 0's on a
    mesh). Returns the float32 wave ((T_frames - 1)*hop,) with no mu-law
    decode and no tail fade (module docstring): a numpy array, or a tensor
    on the device with ``device_out``. ``sparse_packed`` serves the
    crossfade modes' sparse arm (B9); exact-seam passes run a pruned
    model's masked weights dense, as the JAX package does. ``mesh``: a
    ``DeviceMesh`` with a ``"data"`` dimension, every rank calling with
    the same arguments (module docstring); every rank returns the whole
    wave."""
    dev = resolve_device(device, model)
    voc, dsp = model.voc, model.dsp
    target = voc.target if target is None else target
    overlap = voc.overlap if overlap is None else overlap
    mels = torch.as_tensor(mels, dtype=torch.float32, device=dev)
    hop = dsp.hop_length
    wave_len = (mels.shape[-1] - 1) * hop
    total_len = mels.shape[-1] * hop
    seed = same_seed(wr._seed(noise, generator), mesh)
    core = model.core_weights()
    mels_p = torch.nn.functional.pad(mels, (voc.pad, voc.pad))
    fused = wr.fused_cond_ok(voc, dsp, target, overlap)
    t0 = time.perf_counter()
    if fused:
        frames, phi, geo, fold_chunks = wr.fused_conditioning(
            model, mels_p, total_len, target, overlap)
        sh = FoldShard(frames.shape[1], mesh)
        args = (core, sh.take(frames, 1), phi, geo.hop, -geo.d_lo,
                fold_chunks, voc.mode)
        if seam_passes > 0:
            samples, _ = generate_exact_seam_fused(
                *args, target, overlap, seam_passes, noise=sh.noise(noise),
                seed=seed, mesh=mesh, **sh.rows())
        else:
            samples = generate_fused(*args, noise=sh.noise(noise), seed=seed,
                                     sparse_packed=sparse_packed,
                                     **sh.rows())
    else:
        mels_up, aux = model.upsample(mels_p)
        mels_up = fold_with_overlap(mels_up, target, overlap)
        aux = fold_with_overlap(aux, target, overlap)
        sh = FoldShard(mels_up.shape[0], mesh)
        mels_up, aux = sh.take(mels_up, 0), sh.take(aux, 0)
        if seam_passes > 0:
            samples, _ = generate_exact_seam(
                core, mels_up, aux, voc.mode, target, overlap, seam_passes,
                noise=sh.noise(noise), seed=seed, mesh=mesh, **sh.rows())
        else:
            samples = generate_materialized(
                core, mels_up, aux, voc.mode, noise=sh.noise(noise),
                seed=seed, sparse_packed=sparse_packed, **sh.rows())[0]
    samples = sh.gather(samples)
    if seam_passes > 0:
        wav = concat_folds(samples, target, overlap, wave_len)
    else:
        wav = xfade_and_unfold(samples, overlap)[:wave_len]
        if fused:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            last_stats.clear()
            last_stats.update({"wall_s": time.perf_counter() - t0,
                               **sh.stats()})
    return wav if device_out else wav.cpu().numpy()


def generate_multi_sharded(model: wr.WaveRNN, mels_list, mesh, *,
                           target: Optional[int] = None,
                           overlap: Optional[int] = None,
                           mu_law: bool = True, noise=None,
                           generator: Optional[torch.Generator] = None,
                           device="cuda", device_out: bool = False,
                           tail_fade: bool = True, timings=None,
                           sparse_packed=None):
    """Batched multi-utterance serving on a mesh (gen_sharded.py:484-539):
    ``models/wavernn.generate_multi``'s contract, every utterance's folds
    in one combined fold batch sharded over the ranks, one sample-loop
    launch a rank (B1, B9 with ``sparse_packed``), the samples all-gathered
    and each utterance post-processed on the device. Needs hop-multiple
    target and overlap (the reference defaults), as the JAX package does.
    ``noise``: injected uniforms over the combined fold batch; with it, or
    with one seed, the waves equal the one-device ``generate_multi``'s on
    every rank whatever the world size."""
    voc, dsp = model.voc, model.dsp
    target = voc.target if target is None else target
    overlap = voc.overlap if overlap is None else overlap
    if not wr.fused_cond_ok(voc, dsp, target, overlap):
        raise ValueError("generate_multi_sharded needs target and overlap "
                         "that are multiples of hop")
    return wr.generate_multi(model, mels_list, target=target,
                             overlap=overlap, mu_law=mu_law, noise=noise,
                             generator=generator, device=device,
                             device_out=device_out, tail_fade=tail_fade,
                             timings=timings, sparse_packed=sparse_packed,
                             mesh=mesh)
