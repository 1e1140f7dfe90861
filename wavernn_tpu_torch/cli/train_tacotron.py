"""CLI: Tacotron training with the PyTorch/CUDA port (reference
train_tacotron.py), in the mode the hparams file's ``mode`` names.

    python -m wavernn_tpu_torch.cli.train_tacotron --hp_file hparams.py \\
        [--force_gta] [--force_attn]

Trains on CUDA through the progressive schedule (``tts_schedule``), or on
the CPU with --force_cpu (the kernels' plain PyTorch versions); under
``torchrun`` (``scripts/torchrun_train.sh``) data parallel, one process per
GPU, each rank on its slice of every session's global batch (the batch
sizes must divide by the world size):

- ``teacher_forcing``: the decoder recurrence on the hand-written kernel B6;
- ``attention_forcing_online``: the student's recurrence on kernel B7,
  context from the attention of the frozen teacher-forcing model at
  ``model_tf_path`` (its eval forward on B6), loss + attn_loss_coeff x KL;
- ``attention_forcing_offline``: B7 with the attention maps under
  ``<data_path>/<attn_ref_path>/`` (written by --force_attn), loss +
  attn_loss_coeff x L1.

The four CBHG BiGRU directions run on kernel B5 in every mode. A fresh
run warm-starts from ``tts_init_weights_path`` when it is set. At each
checkpoint the attention of the dataset's longest item, when it is in the
batch, goes to ``checkpoints/<tts_id>.tacotron/attention/<step>.png``.
--force_gta / --force_attn write the teacher-forced GTA mels / attention
maps of the dataset from the latest checkpoint and exit. Checkpoints are
the JAX package's .npz pair, so either package resumes the other's run.
"""
from __future__ import annotations

import argparse
import math

import torch

from ..data.dataset import get_tts_datasets
from ..train import tacotron_train as tt
from ..utils.display import save_attention, save_spectrogram
from ..utils.seeding import set_global_seeds
from .common import (devices_line, join_ranks, load_config, load_tts_model,
                     make_workspace, restore_on_ranks, shards)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train Tacotron (teacher forcing, or attention forcing "
                    "online / offline, as the hparams' mode says), data "
                    "parallel over the ranks under torchrun")
    parser.add_argument("--force_train", "-f", action="store_true",
                        help="accepted for the reference's flag surface; "
                             "the schedule decides the steps")
    parser.add_argument("--force_gta", "-g", action="store_true",
                        help="write GTA mels of the dataset and exit")
    parser.add_argument("--force_attn", "-a", action="store_true",
                        help="write attention maps of the dataset and exit")
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="train on the CPU with the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("--seed", type=int, default=0,
                        help="the run's seed; the hparams' random_seed, "
                             "when set, takes its place")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first "
                             "training steps into this directory")
    args = parser.parse_args(argv)
    cfg = load_config(args.hp_file)
    if cfg.random_seed is not None:
        # the hparams' seed wins over --seed (wavernn_tpu/cli/
        # train_tacotron.py:40-43): the initialisation and the batch order
        args.seed = cfg.random_seed
        set_global_seeds(cfg.random_seed)
    mode, tt_cfg = cfg.tts.mode, cfg.tts_train
    if mode == "attention_forcing_online" and not tt_cfg.model_tf_path:
        raise ValueError("attention_forcing_online needs model_tf_path, the "
                         "teacher-forcing model (train_tacotron.py:78-92)")
    if mode == "attention_forcing_offline" and not tt_cfg.attn_ref_path:
        raise ValueError("attention_forcing_offline needs attn_ref_path, "
                         "the attention maps under data_path")
    ws = make_workspace(cfg)
    schedule = cfg.tts_train.schedule
    # one mesh serves every session of the schedule: its world size must
    # divide each session's batch (wavernn_tpu/cli/train_tacotron.py:76-82)
    device, mesh = join_ranks(args.force_cpu,
                              math.gcd(*(bs for _, _, _, bs in schedule)))
    lead = mesh is None or shards(mesh)[1] == 0
    say = print if lead else (lambda *a: None)

    state = tt.create_train_state(cfg.tts, cfg.dsp.num_mels, schedule[0][1],
                                  cfg.tts_train.clip_grad_norm,
                                  seed=args.seed, device=device)
    state.step = restore_on_ranks(
        "tts", ws, state.model, state.opt, mesh,
        init_weights_path=cfg.tts_train.init_weights_path)

    if (args.force_gta or args.force_attn) and not lead:
        return          # the exports are rank 0's: one writer of the files
    if args.force_gta or args.force_attn:
        r = tt.session_for_step(schedule, state.step)[0]
        ds, _ = get_tts_datasets(ws.data, 8, r, cfg, seed=args.seed)
        if args.force_gta:
            tt.create_gta_features(state.model, ds, r, ws.gta,
                                   recurrence=cfg.tts_train.recurrence)
        if args.force_attn:
            tt.create_attn_ref(state.model, ds, r, ws.attn,
                               recurrence=cfg.tts_train.recurrence)
        return

    n_params = sum(p.numel() for p in state.model.parameters())
    for name, value in (
            ("Trainable Parameters", f"{n_params / 1e6:.3f}M"),
            ("Mode", cfg.tts.mode), ("Step", state.step),
            ("Schedule", len(schedule)),
            ("Max mel len", cfg.tts_train.max_mel_len), ("Device", device),
            ("Devices", devices_line(mesh, device)),
            ("Recurrence", cfg.tts_train.recurrence)):
        say(f"| {name}: {value}")

    num_shards, shard_index = shards(mesh)

    def make_dataset(r, bs):
        ds, make_dataset.attn_example = get_tts_datasets(
            ws.data, bs, r, cfg, seed=args.seed, num_shards=num_shards,
            shard_index=shard_index)
        return ds

    def on_checkpoint(st, metrics, ids):
        # the attention plot of the dataset's attn_example when it is in
        # this batch, and its mel plot when the step returns one
        # (train_tacotron.py:216-219); rank 0 alone is called
        ex = getattr(make_dataset, "attn_example", None)
        if ex is None or ex not in ids:
            return
        idx = list(ids).index(ex)
        save_attention(metrics["attn"][idx], ws.tts_attention / f"{st.step}")
        if "mel" in metrics:
            save_spectrogram(metrics["mel"][idx],
                             ws.tts_mel_plot / f"{st.step}")

    teacher = None
    if mode == "attention_forcing_online":
        # the frozen teacher (wavernn_tpu/cli/train_tacotron.py:55-60)
        teacher = load_tts_model(tt_cfg.model_tf_path, cfg, device)[0]
        teacher.requires_grad_(False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    tt.train_loop(cfg, ws, state, make_dataset, generator=generator,
                  on_checkpoint=on_checkpoint, profile_dir=args.profile_dir,
                  teacher=teacher, mesh=mesh)
    say("Training Complete.")


if __name__ == "__main__":
    main()
