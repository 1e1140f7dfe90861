"""CLI: vocoder training with the PyTorch/CUDA port (reference
train_wavernn.py).

    python -m wavernn_tpu_torch.cli.train_wavernn --hp_file hparams.py \\
        [--gta] [--lr 1e-4] [--batch_size 32]

Trains on CUDA (the two GRU recurrences of every step run on the
hand-written kernel B5), or on the CPU with --force_cpu (the kernels' plain
PyTorch versions). Under ``torchrun`` (``scripts/torchrun_train.sh``) it
trains data parallel, one process per GPU: each rank takes its slice of
every global batch of --batch_size, and the gradients are averaged over the
ranks (NCCL; gloo with --force_cpu). Checkpoints are the JAX package's .npz
pair, so either package resumes the other's run.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from ..data.dataset import get_vocoder_datasets
from ..synthesis import gen_testset
from ..train import wavernn_train as wt
from .common import (devices_line, join_ranks, load_config, make_workspace,
                     restore_on_ranks, shards)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train the WaveRNN vocoder (data parallel over the "
                    "ranks under torchrun)")
    parser.add_argument("--lr", "-l", type=float)
    parser.add_argument("--batch_size", "-b", type=int)
    parser.add_argument("--force_train", "-f", action="store_true")
    parser.add_argument("--gta", "-g", action="store_true",
                        help="train on GTA features")
    parser.add_argument("--prune", action="store_true",
                        help="magnitude pruning with the cubic schedule of "
                             "the voc_prune_* hparams ((128, 128) blocks "
                             "by default, which gen_wavernn --sparse and "
                             "gen_tacotron --sparse serve)")
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="train on the CPU with the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the first "
                             "training steps into this directory")
    args = parser.parse_args(argv)
    cfg = load_config(args.hp_file)
    if args.prune and not cfg.voc_train.prune:
        cfg = dataclasses.replace(cfg, voc_train=dataclasses.replace(
            cfg.voc_train, prune=True))
    lr = args.lr or cfg.voc_train.lr
    batch_size = args.batch_size or cfg.voc_train.batch_size
    device, mesh = join_ranks(args.force_cpu, batch_size)
    lead = mesh is None or shards(mesh)[1] == 0
    say = print if lead else (lambda *a: None)
    ws = make_workspace(cfg)

    # the upsample factors must exactly factorise hop (train_wavernn.py:68)
    assert math.prod(cfg.voc.upsample_factors) == cfg.dsp.hop_length

    state = wt.create_train_state(cfg.voc, cfg.dsp, lr,
                                  cfg.voc_train.clip_grad_norm,
                                  seed=args.seed, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"Trainable Parameters: {n_params / 1e6:.3f}M")
    state.step = restore_on_ranks(
        "voc", ws, state.model, state.opt, mesh,
        init_weights_path=cfg.voc_train.init_weights_path)

    num_shards, shard_index = shards(mesh)
    train_set, test_set = get_vocoder_datasets(
        ws.data, batch_size, cfg, train_gta=args.gta,
        tts_model_id=cfg.tts_model_id if args.gta else "", seed=args.seed,
        num_shards=num_shards, shard_index=shard_index)

    total_steps = (10_000_000 if args.force_train
                   else cfg.voc_train.total_steps)
    vt = cfg.voc_train
    for name, value in (
            ("Remaining", f"{(total_steps - state.step) // 1000}k Steps"),
            ("Batch Size", batch_size), ("LR", lr),
            ("Sequence Len", cfg.voc_train.seq_len), ("GTA Train", args.gta),
            ("Device", device), ("Devices", devices_line(mesh, device)),
            ("Recurrence", cfg.voc_train.recurrence),
            ("Precision", cfg.voc_train.precision),
            ("Pruning", (f"{vt.prune_sparsity:.2%} by step "
                         f"{vt.prune_start + vt.prune_steps}"
                         if vt.prune else "off"))):
        say(f"| {name}: {value}")

    def on_checkpoint(st):
        gen_testset(st.model, test_set, cfg.voc_train.gen_at_checkpoint,
                    cfg.voc.gen_batched, cfg.voc.target, cfg.voc.overlap,
                    ws.voc_output, cfg,
                    step=st.step,
                    generator=torch.Generator().manual_seed(args.seed),
                    device=device)

    wt.train_loop(cfg, ws, train_set, state, lr=lr, total_steps=total_steps,
                  on_checkpoint=on_checkpoint, profile_dir=args.profile_dir,
                  mesh=mesh)
    say("Training Complete.")


if __name__ == "__main__":
    main()
