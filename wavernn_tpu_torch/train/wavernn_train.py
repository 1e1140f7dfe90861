"""WaveRNN training step and loop (port of ``wavernn_tpu.train.wavernn_train``;
reference train_wavernn.py:18-162).

Loss: RAW -> cross-entropy over 2**bits classes; MOL -> the discretized
mixture-of-logistics NLL, in float32 either way. The optimizer is optax's
``chain(clip_by_global_norm(4), adam(lr))``: the clip is written out with
optax's rule, Adam is ``torch.optim.Adam`` with optax's constants. With
``voc_prune`` the loop prunes as the JAX loop does (train/pruning.py): the
masks of step t are applied to the weights after its optimizer update.

Data parallel (``mesh=``, parallel/mesh.py): one process per GPU, the
parameters and the optimizer state replicated (rank 0's, broadcast at the
start), each rank's batch its contiguous shard of the global batch, on
which it runs the kernels (B5 included: the JAX package falls back to the
scan on a mesh only because GSPMD cannot partition a ``pallas_call``).
After the backward one flat all-reduce averages the gradients and the
loss, before the clip: the JAX step's psum-then-clip. Every loss is a mean
over equal per-rank shapes, so the average of the ranks' means is the
global batch's; BatchNorm normalises on the whole batch's statistics. The
steps are functions, not one module's ``forward``, so an explicit
all-reduce fits them better than a DDP wrapper.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import Config, DSPConfig, WaveRNNConfig
from ..models import wavernn as wr
from ..models.distribution import discretized_mix_logistic_loss
from ..parallel.mesh import (all_reduce_mean_, barrier, rank, replicate_,
                             set_batchnorm_mesh)
from ..timing import stage
from ..utils.backend import resolve_recurrence
from .pruning import Pruner, apply_masks, wavernn_prune_spec


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all gradients together (one
    multi-tensor norm per dtype and device, no host synchronisation)."""
    return torch.nn.utils.get_total_norm(grads)


def clip_by_global_norm_(grads, norm, max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: every gradient is scaled by
    max_norm / norm when norm >= max_norm and left as it is otherwise (a
    factor of exactly 1). ``torch.nn.utils.clip_grad_norm_`` differs: it
    scales by max_norm / (norm + 1e-6) whenever that is below 1. One
    multi-tensor multiply, no host synchronisation. Autograd hands two
    parameters summed in the forward one gradient tensor (Tacotron's
    ``b_ih + b_hh``, B6's and B7's operands): each tensor is scaled
    once."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(_distinct(grads), factor)


def _distinct(tensors):
    """Each tensor once, in order (a gradient two parameters share)."""
    return list({id(t): t for t in tensors}.values())


class Optimizer:
    """chain(clip_by_global_norm(clip_grad_norm), adam(lr)) over the
    model's parameters; ``clip_grad_norm=None`` leaves the clip out."""

    def __init__(self, params, lr: float,
                 clip_grad_norm: Optional[float] = 4.0):
        self.params = list(params)
        self.clip_grad_norm = clip_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def set_lr(self, lr: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = lr

    def step(self, grads) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter); returns the
        global norm of the unclipped gradients as a device scalar."""
        norm = global_norm(grads)
        if self.clip_grad_norm is not None:
            clip_by_global_norm_(grads, norm, self.clip_grad_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None
        return norm


def make_optimizer(model, lr: float,
                   clip_grad_norm: Optional[float] = 4.0) -> Optimizer:
    """Adam with global-norm clipping (train_wavernn.py:70,134-138)."""
    return Optimizer(model.parameters(), lr, clip_grad_norm)


@dataclass
class TrainState:
    model: wr.WaveRNN
    opt: Optimizer
    step: int


def create_train_state(voc: WaveRNNConfig, dsp: DSPConfig, lr: float,
                       clip_grad_norm: Optional[float] = 4.0, seed: int = 0,
                       device="cuda") -> TrainState:
    """A fresh WaveRNN (weights from ``seed``) on ``device`` and its
    optimizer."""
    model = wr.WaveRNN(voc, dsp)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device)
    return TrainState(model, make_optimizer(model, lr, clip_grad_norm), 0)


def logits_loss(logits, y, mode: str):
    """The loss of float32 logits: RAW -> the cross-entropy of the labels
    y, MOL -> the mixture-of-logistics NLL of the targets y in [-1, 1]."""
    if mode == "RAW":
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))
    if mode == "MOL":
        return discretized_mix_logistic_loss(logits, y.float())
    raise ValueError(mode)


def loss_fn(model, x, y, mels, voc: WaveRNNConfig, compute_dtype=None,
            recurrence: str = "auto"):
    """The training loss; BatchNorm's running statistics update in place.
    The loss itself is always float32 (forward returns float32 logits)."""
    logits = wr.forward(model, x, mels, training=True,
                        compute_dtype=compute_dtype, recurrence=recurrence)
    return logits_loss(logits, y, voc.mode)


def loss_and_grads(model, x, y, mels, voc: WaveRNNConfig, compute_dtype=None,
                   recurrence: str = "auto", timings: Optional[dict] = None):
    """(loss, gradients in ``model.parameters()`` order)."""
    dev = x.device
    with stage(timings, "forward", dev):
        loss = loss_fn(model, x, y, mels, voc, compute_dtype, recurrence)
    with stage(timings, "backward", dev):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), list(grads)


def average_over_mesh(losses, grads, mesh):
    """The data-parallel all-reduce: the gradients (in place) and the
    scalar ``losses`` averaged over the ranks, in one flat buffer. Returns
    the global losses."""
    flat = torch.stack(list(losses))
    all_reduce_mean_(_distinct(grads) + [flat], mesh)
    return tuple(flat)


def train_step(state: TrainState, x, y, mels, voc: WaveRNNConfig,
               precision: str = "float32", recurrence: str = "auto",
               timings: Optional[dict] = None, masks=None,
               mesh=None) -> dict:
    """One optimizer step on ``state`` in place. Returns {"loss",
    "grad_norm"} as device scalars (no host synchronisation).

    precision="bfloat16" runs the core GRU/FC stack forward and backward in
    bfloat16 with float32 master weights, optimizer state and BatchNorm
    statistics. ``recurrence``: "auto"/"pallas" run the two GRUs on the
    kernel B5, "scan" on the plain step loop. BatchNorm's new running
    statistics were written by the forward; the optimizer never touches
    them, so they stand after the update as in the JAX step.
    ``timings``, when given, receives CUDA-event records of the forward,
    backward and optimizer stages. ``masks``: pruning masks by parameter
    name (train/pruning.py), multiplied into the weights in place after the
    update, so the next forward sees pruned weights (reference
    Pruner.apply_or_not); Adam's moments are left as they are, as in the
    JAX step. ``mesh``: x, y, mels are this rank's shard; the loss and the
    gradients are averaged over the ranks before the clip (every rank then
    applies the same update, and the same masks)."""
    compute_dtype = torch.bfloat16 if precision == "bfloat16" else None
    set_batchnorm_mesh(state.model, mesh)
    loss, grads = loss_and_grads(state.model, x, y, mels, voc, compute_dtype,
                                 resolve_recurrence(recurrence, mesh),
                                 timings)
    if mesh is not None:
        with stage(timings, "all_reduce", x.device):
            loss, = average_over_mesh((loss,), grads, mesh)
    with stage(timings, "optimizer", x.device):
        gnorm = state.opt.step(grads)
        if masks is not None:
            apply_masks(dict(state.model.named_parameters()), masks)
    state.step += 1
    return {"loss": loss, "grad_norm": gnorm}


def join_mesh(model, optimizer, mesh) -> bool:
    """Before a data-parallel loop: every rank takes rank 0's parameters,
    buffers and optimizer state. Returns whether this process leads
    (writes the files): rank 0, or the only process."""
    if mesh is None:
        return True
    replicate_(model, mesh, optimizer)
    return rank(mesh) == 0


def train_loop(cfg: Config, workspace, dataset, state: TrainState,
               lr: Optional[float] = None, total_steps: Optional[int] = None,
               log=print, checkpoint_every: Optional[int] = None,
               on_checkpoint=None, profile_dir=None,
               profile_steps: int = 20, mesh=None) -> TrainState:
    """Epoch loop (train_wavernn.py:98-162): periodic named checkpoints,
    the latest checkpoint, a log line and a ``metrics.jsonl`` record per
    epoch.

    The loop never waits for the device within an epoch: loss and the
    counts of non-finite losses and gradient norms accumulate as device
    scalars, the step counter lives on the host, and a prefetch thread
    collates the next batches into pinned memory while the device works.
    One synchronisation per epoch (and one per checkpoint record).
    ``profile_dir``: a torch.profiler trace of the first ``profile_steps``
    steps (the --profile_dir flag). ``mesh``: data parallel (module
    docstring); ``dataset`` yields this rank's shards. Rank 0 alone writes
    the checkpoints, the logs and the metrics and calls ``on_checkpoint``;
    the others wait for it at a barrier."""
    from ..data.prefetch import prefetch
    from ..utils.metrics import MetricsLogger, StepTimer, profile_trace
    from .checkpoints import save_checkpoint

    vt = cfg.voc_train
    lr = vt.lr if lr is None else lr
    total_steps = vt.total_steps if total_steps is None else total_steps
    checkpoint_every = (vt.checkpoint_every if checkpoint_every is None
                        else checkpoint_every)
    state.opt.set_lr(lr)
    dev = next(state.model.parameters()).device
    lead = join_mesh(state.model, state.opt.adam, mesh)
    log = log if lead else (lambda *a, **k: None)
    params = dict(state.model.named_parameters())
    pruner = None
    if vt.prune:
        pruner = Pruner(wavernn_prune_spec(vt.prune_rnn_input),
                        vt.prune_start, vt.prune_steps, vt.prune_sparsity,
                        vt.prune_every, block=vt.prune_block)
        if state.step > vt.prune_start:   # resume: recompute at step t
            pruner.restart(params, state.step)

    metrics_log = MetricsLogger(workspace.voc_metrics)
    timer = StepTimer()
    profiler = None
    if profile_dir is not None:
        profiler = profile_trace(profile_dir)
        profiler.__enter__()
    profile_until = state.step + profile_steps

    while state.step < total_steps:
        start = time.time()
        running = torch.zeros((), dtype=torch.float32, device=dev)
        bad_loss = torch.zeros((), dtype=torch.int32, device=dev)
        bad_grad = torch.zeros((), dtype=torch.int32, device=dev)
        i = 0
        for x, y, m in prefetch(dataset, device=dev):
            i += 1
            masks = (pruner.masks_for_step(params, state.step)
                     if pruner is not None else None)
            metrics = train_step(state, x, y, m, cfg.voc, vt.precision,
                                 vt.recurrence, masks=masks, mesh=mesh)
            running += metrics["loss"]
            bad_loss += (~torch.isfinite(metrics["loss"])).int()
            bad_grad += (~torch.isfinite(metrics["grad_norm"])).int()
            timer.tick()  # host-side rolling steps/s, no device sync
            if profiler is not None and state.step >= profile_until:
                profiler.__exit__(None, None, None)
                profiler = None
            if state.step % checkpoint_every == 0:
                if lead:
                    save_checkpoint("voc", workspace, state.model, state.opt,
                                    state.step,
                                    name=f"wave_step{state.step // 1000}K",
                                    log=log)
                    metrics_log.log(event="checkpoint", step=state.step,
                                    loss=round(float(metrics["loss"]), 6),
                                    steps_per_s=round(timer.steps_per_sec,
                                                      3))
                    if on_checkpoint is not None:
                        on_checkpoint(state)
                barrier(mesh)
            if state.step >= total_steps:
                break
        n_bad_loss, n_bad = int(bad_loss), int(bad_grad)  # one sync per epoch
        if n_bad:
            log(f"grad_norm was non-finite on {n_bad} step(s)!")
        speed = i / max(time.time() - start, 1e-9)
        avg = float(running) / max(i, 1)
        msg = (f"| Epoch done | Loss: {avg:.4f} | {speed:.1f} steps/s "
               f"| Step: {state.step // 1000}k |")
        if lead:
            log(msg)
            with open(workspace.voc_log, "a") as f:
                print(msg, file=f)
            metrics_log.log(event="epoch", step=state.step,
                            loss=round(avg, 6), steps_per_s=round(speed, 3),
                            nonfinite_grad_steps=n_bad,
                            nonfinite_loss_steps=n_bad_loss)
            save_checkpoint("voc", workspace, state.model, state.opt,
                            state.step, log=log)
        barrier(mesh)
    if profiler is not None:
        profiler.__exit__(None, None, None)
    return state
