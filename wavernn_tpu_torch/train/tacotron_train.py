"""Tacotron teacher-forcing training (port of the TF parts of
``wavernn_tpu.train.tacotron_train``; reference train_tacotron.py:98-485).

The loss is L1(mel, m) + L1(linear, m) over the padded batch. The optimizer
is the vocoder trainer's: Adam with optax's global-norm clip rule (here at
``tts_clip_grad_norm`` = 1.0), the learning rate set per session of the
progressive (r, lr, step, batch size) schedule. The attention-forcing modes
wait for kernel B7 (ROADMAP B7); one device only (the data-parallel mesh is
ROADMAP A11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, TacotronConfig
from ..models import tacotron as taco
from ..timing import stage
from .wavernn_train import Optimizer, make_optimizer


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


def loss_and_grads(model, x_ids, m, r: int, recurrence: str = "auto",
                   masks=None, generator=None,
                   timings: Optional[dict] = None):
    """(loss, attn, gradients in ``model.parameters()`` order)."""
    dev = m.device
    with stage(timings, "forward", dev):
        loss, attn = loss_tf(model, x_ids, m, r, recurrence, masks,
                             generator)
    with stage(timings, "backward", dev):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), attn.detach(), list(grads)


def train_step_tf(state: TTSTrainState, x_ids, m, r: int,
                  recurrence: str = "auto", masks=None, generator=None,
                  timings: Optional[dict] = None) -> dict:
    """One optimizer step on ``state`` in place. Returns {"loss",
    "grad_norm", "attn"} on the device (no host synchronisation)."""
    loss, attn, grads = loss_and_grads(state.model, x_ids, m, r, recurrence,
                                       masks, generator, timings)
    with stage(timings, "optimizer", m.device):
        gnorm = state.opt.step(grads)
    state.step += 1
    return {"loss": loss, "grad_norm": gnorm, "attn": attn}


def train_loop(cfg: Config, workspace, state: TTSTrainState, make_dataset,
               log=print, max_steps: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               on_checkpoint=None, profile_dir=None,
               profile_steps: int = 20) -> TTSTrainState:
    """Progressive-schedule training loop (train_tacotron.py:98-430).

    ``make_dataset(r, batch_size)`` gives an iterable of collated batches.
    Each session sets its r (also ``decoder.r``) and lr and trains until
    its step; a checkpoint pair is written every ``checkpoint_every`` steps
    with a named ``taco_step{k}K`` snapshot, and at each session's end;
    ``metrics.jsonl`` gets a record per checkpoint and per session and
    ``log.txt`` a line per session. Losses and the counts of non-finite
    losses and gradient norms accumulate on the device: one
    synchronisation per session and per checkpoint record.
    ``profile_dir``: a torch.profiler trace of the first ``profile_steps``
    steps."""
    from ..data.prefetch import prefetch
    from ..utils.metrics import MetricsLogger, StepTimer, profile_trace
    from .checkpoints import save_checkpoint

    tt = cfg.tts_train
    if cfg.tts.mode != "teacher_forcing":
        raise NotImplementedError(
            f"mode {cfg.tts.mode!r}: attention forcing is not ported yet "
            "(ROADMAP B7)")
    dev = next(state.model.parameters()).device
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
            for chars, mel, ids, _ in prefetch(dataset, device=dev):
                metrics = train_step_tf(state, chars, mel, r, tt.recurrence,
                                        generator=generator)
                n += 1
                running += metrics["loss"]
                bad_loss += (~torch.isfinite(metrics["loss"])).int()
                bad_grad += (~torch.isfinite(metrics["grad_norm"])).int()
                timer.tick()
                if profiler is not None and state.step >= profile_until:
                    profiler.__exit__(None, None, None)
                    profiler = None
                if state.step % tt.checkpoint_every == 0:
                    save_checkpoint("tts", workspace, state.model, state.opt,
                                    state.step,
                                    name=f"taco_step{state.step // 1000}K",
                                    log=log, r=r)
                    metrics_log.log(event="checkpoint", step=state.step, r=r,
                                    loss=round(float(metrics["loss"]), 6),
                                    steps_per_s=round(timer.steps_per_sec, 3))
                    if on_checkpoint is not None:
                        on_checkpoint(state, metrics, ids)
                if state.step >= max_step:
                    break
        save_checkpoint("tts", workspace, state.model, state.opt, state.step,
                        log=log, r=r)
        avg = float(running) / max(n, 1)              # one sync per session
        n_bad_loss, n_bad = int(bad_loss), int(bad_grad)
        if n_bad:
            log(f"grad_norm was non-finite on {n_bad} step(s)!")
        msg = (f"| Session {session_idx} done | loss {avg:.4f} | step "
               f"{state.step} |")
        log(msg)
        with open(workspace.tts_log, "a") as f:
            print(msg, file=f)
        metrics_log.log(event="session", session=session_idx,
                        step=state.step, r=r, loss=round(avg, 6),
                        steps=n, nonfinite_loss_steps=n_bad_loss,
                        nonfinite_grad_steps=n_bad,
                        steps_per_s=round(timer.steps_per_sec, 3))
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
    for i, (x_ids, m, ids, mel_lens) in enumerate(dataset):
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
