"""Tacotron training (port of ``wavernn_tpu.train.tacotron_train``;
reference train_tacotron.py:98-485) in the fork's three loss modes:

- teacher forcing (TF): L1(mel, m) + L1(linear, m) over the padded batch;
- attention forcing online (AF-online): a frozen TF teacher gives attn_ref
  for every batch (``teacher_attn_ref``), the student runs attention
  forcing, and the loss adds ``attn_loss_coeff`` x KL(teacher || student)
  summed over the text axis and averaged over the rest
  (train_tacotron.py:286-294);
- attention forcing offline (AF-offline): attn_ref comes from disk with the
  batch, and the loss adds ``attn_loss_coeff`` x the mean L1 of the two
  attention maps (train_tacotron.py:387).

The optimizer is the vocoder trainer's: Adam with optax's global-norm clip
rule (here at ``tts_clip_grad_norm`` = 1.0), the learning rate set per
session of the progressive (r, lr, step, batch size) schedule.

Data parallel (``mesh=``): as the vocoder trainer (train/wavernn_train.py),
each rank on its shard of the global batch (B6, B7 and B5 on it; the
AF-online teacher's B6 forward on it too; AF-offline's attention maps
sliced with the batch), one flat all-reduce of the gradients and the loss
parts before the clip. The random draws of a step (the prenets' dropout,
zoneout) are drawn for the whole batch on every rank from the same
generator and sliced, so the ranks together draw what one process draws.
Every loss normaliser is a mean over each rank's equal, globally padded
shapes (``mean |mel - m|`` counts padded frames as the JAX loss does; the
KL term averages over batch and group), so the average of the ranks'
losses is the global batch's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, TacotronConfig
from ..models import tacotron as taco
from ..timing import stage
from ..parallel.mesh import barrier, set_batchnorm_mesh
from .wavernn_train import (Optimizer, average_over_mesh, join_mesh,
                            make_optimizer)


@dataclass
class TTSTrainState:
    model: taco.Tacotron
    opt: Optimizer
    step: int


def create_train_state(tts: TacotronConfig, n_mels: int, lr: float,
                       clip_grad_norm: Optional[float] = 1.0, seed: int = 0,
                       device="cuda") -> TTSTrainState:
    """A fresh Tacotron (weights from ``seed``) on ``device`` and its
    optimizer."""
    model = taco.Tacotron(tts, n_mels)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device)
    return TTSTrainState(model, make_optimizer(model, lr, clip_grad_norm), 0)


def session_for_step(schedule, step: int) -> Tuple[int, float, int, int]:
    """The (r, lr, max_step, batch_size) session of ``step``
    (train_tacotron.py:98-118)."""
    for r, lr, max_step, bs in schedule:
        if step < max_step:
            return r, lr, max_step, bs
    return schedule[-1]


def attention_kl(student_attn, teacher_attn, eps: float = 1e-10):
    """KL(teacher || student) over the text axis, summed there and averaged
    over the rest: the reference's F.kl_div(log(student), teacher)
    (train_tacotron.py:286-294), both clamped below at ``eps``."""
    t = teacher_attn
    s = torch.log(torch.clamp_min(student_attn, eps))
    kl = t * (torch.log(torch.clamp_min(t, eps)) - s)
    return torch.mean(torch.sum(kl, dim=-1))


def loss_tf(model, x_ids, m, r: int, recurrence: str = "auto", masks=None,
            generator=None):
    """(loss, attn): mean |mel - m| + mean |linear - m| of the
    teacher-forcing training forward; BatchNorm's running statistics
    update in place."""
    mel, linear, attn = taco.forward(model, x_ids, m, r,
                                     mode="teacher_forcing", training=True,
                                     recurrence=recurrence, masks=masks,
                                     generator=generator)
    loss = torch.mean(torch.abs(mel - m)) + torch.mean(torch.abs(linear - m))
    return loss, attn


def loss_af(model, x_ids, m, attn_ref, r: int, attn_loss_coeff: float,
            offline: bool, recurrence: str = "auto", masks=None,
            generator=None):
    """(loss, attn, loss_out, loss_attn) of the attention-forcing training
    forward: loss_out = mean |mel - m| + mean |linear - m|; loss_attn the
    mean L1 of attn and attn_ref (offline) or ``attention_kl`` (online);
    loss = loss_out + attn_loss_coeff * loss_attn."""
    mode = ("attention_forcing_offline" if offline
            else "attention_forcing_online")
    mel, linear, attn = taco.forward(model, x_ids, m, r, mode=mode,
                                     training=True, recurrence=recurrence,
                                     masks=masks, generator=generator,
                                     attn_ref=attn_ref)
    loss_out = torch.mean(torch.abs(mel - m)) + torch.mean(
        torch.abs(linear - m))
    if offline:
        loss_attn = torch.mean(torch.abs(attn - attn_ref))
    else:
        loss_attn = attention_kl(attn, attn_ref)
    return loss_out + attn_loss_coeff * loss_attn, attn, loss_out, loss_attn


def _grads(model, loss_fn, dev, timings):
    """(loss, attn, the loss parts, gradients in ``model.parameters()``
    order) of ``loss_fn() -> (loss, attn, *parts)``."""
    with stage(timings, "forward", dev):
        loss, attn, *parts = loss_fn()
    with stage(timings, "backward", dev):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return (loss.detach(), attn.detach(), [p.detach() for p in parts],
            list(grads))


def loss_and_grads(model, x_ids, m, r: int, recurrence: str = "auto",
                   masks=None, generator=None,
                   timings: Optional[dict] = None):
    """(loss, attn, gradients in ``model.parameters()`` order) of
    ``loss_tf``."""
    loss, attn, _, grads = _grads(
        model, lambda: loss_tf(model, x_ids, m, r, recurrence, masks,
                               generator), m.device, timings)
    return loss, attn, grads


def loss_and_grads_af(model, x_ids, m, attn_ref, r: int,
                      attn_loss_coeff: float, offline: bool,
                      recurrence: str = "auto", masks=None, generator=None,
                      timings: Optional[dict] = None):
    """(loss, attn, loss_out, loss_attn, gradients in
    ``model.parameters()`` order) of ``loss_af``."""
    loss, attn, (l_out, l_attn), grads = _grads(
        model, lambda: loss_af(model, x_ids, m, attn_ref, r, attn_loss_coeff,
                               offline, recurrence, masks, generator),
        m.device, timings)
    return loss, attn, l_out, l_attn, grads


def _apply(state: TTSTrainState, grads, timings, dev, mesh=None,
           losses=()):
    """The update from this rank's gradients; on a mesh, the gradients and
    ``losses`` averaged over the ranks first. Returns (the gradients'
    global norm, the losses as the update saw them)."""
    if mesh is not None:
        with stage(timings, "all_reduce", dev):
            losses = average_over_mesh(losses, grads, mesh)
    with stage(timings, "optimizer", dev):
        gnorm = state.opt.step(grads)
    state.step += 1
    return gnorm, tuple(losses)


def rank_masks(model, x_ids, m, r: int, generator, mesh):
    """A mesh step's random draws: ``taco.draw_masks`` for the whole batch
    (this rank's rows times the world size), sliced to this rank's rows,
    so the ranks together draw what one process draws on the batch."""
    from ..parallel.mesh import rank, size
    B, G = m.shape[0], m.shape[2] // r
    full = taco.draw_masks(model, B * size(mesh), x_ids.shape[1], G,
                           generator, m.device)
    rows = slice(rank(mesh) * B, (rank(mesh) + 1) * B)
    return {k: (v[rows] if k.startswith("enc") else v[:, rows]).contiguous()
            for k, v in full.items()}


def _step_masks(state, x_ids, m, r, masks, generator, mesh):
    set_batchnorm_mesh(state.model, mesh)
    if masks is None and mesh is not None:
        masks = rank_masks(state.model, x_ids, m, r, generator, mesh)
    return masks


def train_step_tf(state: TTSTrainState, x_ids, m, r: int,
                  recurrence: str = "auto", masks=None, generator=None,
                  timings: Optional[dict] = None, mesh=None) -> dict:
    """One optimizer step on ``state`` in place. Returns {"loss",
    "grad_norm", "attn"} on the device (no host synchronisation).
    ``mesh``: x_ids, m (and injected ``masks``) are this rank's shard; the
    loss and the gradients are averaged over the ranks (module
    docstring); ``attn`` stays this rank's."""
    masks = _step_masks(state, x_ids, m, r, masks, generator, mesh)
    loss, attn, grads = loss_and_grads(state.model, x_ids, m, r, recurrence,
                                       masks, generator, timings)
    gnorm, (loss,) = _apply(state, grads, timings, m.device, mesh, (loss,))
    return {"loss": loss, "grad_norm": gnorm, "attn": attn}


def train_step_af(state: TTSTrainState, x_ids, m, attn_ref, r: int,
                  attn_loss_coeff: float = 1.0, offline: bool = False,
                  recurrence: str = "auto", masks=None, generator=None,
                  timings: Optional[dict] = None, mesh=None) -> dict:
    """One attention-forcing optimizer step on ``state`` in place
    (train_step_af, ``wavernn_tpu/train/tacotron_train.py:106-122``).
    Returns {"loss", "loss_out", "loss_attn", "grad_norm", "attn"} on the
    device; ``mesh`` as in ``train_step_tf`` (attn_ref this rank's
    shard)."""
    masks = _step_masks(state, x_ids, m, r, masks, generator, mesh)
    loss, attn, l_out, l_attn, grads = loss_and_grads_af(
        state.model, x_ids, m, attn_ref, r, attn_loss_coeff, offline,
        recurrence, masks, generator, timings)
    gnorm, (loss, l_out, l_attn) = _apply(state, grads, timings, m.device,
                                          mesh, (loss, l_out, l_attn))
    return {"loss": loss, "loss_out": l_out, "loss_attn": l_attn,
            "grad_norm": gnorm, "attn": attn}


@torch.no_grad()
def teacher_attn_ref(teacher, x_ids, m, r: int, recurrence: str = "auto"):
    """AF-online: the frozen teacher's attention (B, steps // r, T_text)
    from its eval-mode teacher-forcing forward (train_tacotron.py:268-278);
    the postnet, which does not feed the attention, is skipped. On CUDA
    tensors its decoder runs on B6 and its encoder BiGRU on B5."""
    _, _, attn = taco.forward(teacher, x_ids, m, r, mode="teacher_forcing",
                              training=False, recurrence=recurrence,
                              decoder_only=True)
    return attn


def train_loop(cfg: Config, workspace, state: TTSTrainState, make_dataset,
               log=print, max_steps: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               on_checkpoint=None, profile_dir=None,
               profile_steps: int = 20, teacher=None,
               mesh=None) -> TTSTrainState:
    """Progressive-schedule training loop (train_tacotron.py:98-430).

    ``make_dataset(r, batch_size)`` gives an iterable of collated batches
    (five fields with attn_ref in AF-offline). ``cfg.tts.mode`` picks the
    step: AF-offline takes attn_ref from the batch, AF-online from
    ``teacher`` (a frozen Tacotron, ``teacher_attn_ref``); every other mode
    trains teacher forcing, as the JAX package's loop does.
    Each session sets its r (also ``decoder.r``) and lr and trains until
    its step; a checkpoint pair is written every ``checkpoint_every`` steps
    with a named ``taco_step{k}K`` snapshot, and at each session's end;
    ``metrics.jsonl`` gets a record per checkpoint and per session and
    ``log.txt`` a line per session. Losses and the counts of non-finite
    losses and gradient norms accumulate on the device: one
    synchronisation per session and per checkpoint record.
    ``profile_dir``: a torch.profiler trace of the first ``profile_steps``
    steps. ``mesh``: data parallel (module docstring), ``make_dataset``
    giving this rank's shards; rank 0 alone writes the checkpoints, logs
    and metrics and calls ``on_checkpoint``, the others wait for it at a
    barrier."""
    from ..data.prefetch import prefetch
    from ..utils.metrics import MetricsLogger, StepTimer, profile_trace
    from .checkpoints import save_checkpoint

    tt = cfg.tts_train
    offline = cfg.tts.mode == "attention_forcing_offline"
    online = cfg.tts.mode == "attention_forcing_online"
    if online and teacher is None:
        raise ValueError("attention_forcing_online needs the frozen "
                         "teacher-forcing model (model_tf_path)")
    dev = next(state.model.parameters()).device
    lead = join_mesh(state.model, state.opt.adam, mesh)
    log = log if lead else (lambda *a, **k: None)
    metrics_log = MetricsLogger(workspace.tts_metrics)
    timer = StepTimer()
    profiler = None
    if profile_dir is not None:
        profiler = profile_trace(profile_dir)
        profiler.__enter__()
    profile_until = state.step + profile_steps

    for session_idx, (r, lr, max_step, bs) in enumerate(tt.schedule):
        if state.step >= max_step:
            continue
        if max_steps is not None:
            max_step = min(max_step, max_steps)
        dataset = make_dataset(r, bs)
        log(f"Session {session_idx}: r={r} lr={lr} until step {max_step} "
            f"bs={bs}")
        state.opt.set_lr(lr)
        state.model.decoder.r.fill_(r)
        running = torch.zeros((), dtype=torch.float32, device=dev)
        bad_loss = torch.zeros((), dtype=torch.int32, device=dev)
        bad_grad = torch.zeros((), dtype=torch.int32, device=dev)
        n = 0
        metrics = None
        while state.step < max_step:
            for chars, mel, ids, _, *rest in prefetch(dataset, device=dev):
                if online:
                    rest = [teacher_attn_ref(teacher, chars, mel, r,
                                             tt.recurrence)]
                if online or offline:
                    metrics = train_step_af(
                        state, chars, mel, rest[0], r, tt.attn_loss_coeff,
                        offline, tt.recurrence, generator=generator,
                        mesh=mesh)
                else:
                    metrics = train_step_tf(state, chars, mel, r,
                                            tt.recurrence,
                                            generator=generator, mesh=mesh)
                n += 1
                running += metrics["loss"]
                bad_loss += (~torch.isfinite(metrics["loss"])).int()
                bad_grad += (~torch.isfinite(metrics["grad_norm"])).int()
                timer.tick()
                if profiler is not None and state.step >= profile_until:
                    profiler.__exit__(None, None, None)
                    profiler = None
                if state.step % tt.checkpoint_every == 0:
                    if lead:
                        save_checkpoint(
                            "tts", workspace, state.model, state.opt,
                            state.step,
                            name=f"taco_step{state.step // 1000}K", log=log,
                            r=r)
                        metrics_log.log(
                            event="checkpoint", step=state.step, r=r,
                            loss=round(float(metrics["loss"]), 6),
                            steps_per_s=round(timer.steps_per_sec, 3))
                        if on_checkpoint is not None:
                            on_checkpoint(state, metrics, ids)
                    barrier(mesh)
                if state.step >= max_step:
                    break
        if lead:
            save_checkpoint("tts", workspace, state.model, state.opt,
                            state.step, log=log, r=r)
        avg = float(running) / max(n, 1)              # one sync per session
        n_bad_loss, n_bad = int(bad_loss), int(bad_grad)
        if n_bad:
            log(f"grad_norm was non-finite on {n_bad} step(s)!")
        msg = (f"| Session {session_idx} done | loss {avg:.4f} | step "
               f"{state.step} |")
        if lead:
            log(msg)
            with open(workspace.tts_log, "a") as f:
                print(msg, file=f)
            metrics_log.log(event="session", session=session_idx,
                            step=state.step, r=r, loss=round(avg, 6),
                            steps=n, nonfinite_loss_steps=n_bad_loss,
                            nonfinite_grad_steps=n_bad,
                            steps_per_s=round(timer.steps_per_sec, 3))
        barrier(mesh)
        if max_steps is not None and state.step >= max_steps:
            break
    if profiler is not None:
        profiler.__exit__(None, None, None)
    return state


# --------------------------------------------------------------------------
# GTA / attention-reference export (train_tacotron.py:433-485)
# --------------------------------------------------------------------------

@torch.no_grad()
def _export(model, dataset, r: int, recurrence: str):
    dev = next(model.parameters()).device
    for i, (x_ids, m, ids, mel_lens, *_) in enumerate(dataset):
        x_ids = torch.as_tensor(x_ids, device=dev)
        m = torch.as_tensor(m, device=dev)
        _, gta, attn = taco.forward(model, x_ids, m, r,
                                    mode="teacher_forcing", training=False,
                                    generate_gta=True, recurrence=recurrence)
        yield i, gta.cpu().numpy(), attn.cpu().numpy(), ids, mel_lens


def create_gta_features(model, dataset, r: int, save_dir, log=print,
                        recurrence: str = "auto"):
    """Teacher-forced eval forward over the dataset; saves the postnet
    output rescaled (x + 4) / 8, cut to each item's mel length."""
    save_dir.mkdir(parents=True, exist_ok=True)
    for i, gta, _, ids, mel_lens in _export(model, dataset, r, recurrence):
        gta = (gta + 4.0) / 8.0
        for j, item_id in enumerate(ids):
            np.save(save_dir / f"{item_id}.npy",
                    gta[j, :, : int(mel_lens[j])], allow_pickle=False)
        log(f"GTA batch {i + 1} saved")


def create_attn_ref(model, dataset, r: int, save_dir, log=print,
                    recurrence: str = "auto"):
    """Saves the teacher-forced attention maps (G, T_text), for offline
    attention forcing."""
    save_dir.mkdir(parents=True, exist_ok=True)
    for i, _, attn, ids, _ in _export(model, dataset, r, recurrence):
        for j, item_id in enumerate(ids):
            np.save(save_dir / f"{item_id}.npy", attn[j], allow_pickle=False)
        log(f"attn_ref batch {i + 1} saved")
