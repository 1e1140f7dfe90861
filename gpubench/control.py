#!/usr/bin/env python3
"""The readings the limits of a cell's check are set from, on a card.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 --seconds 12
    python3 gpubench/control.py --workload <training cell> --seeds 1 ... 12 \
        --controls 3

For each seed, in one process: a run's set-up and a window of
``--seconds`` at the cell's own load, the check's numbers for the program
(the lower readings), then the same numbers for the control: the plain
reference put in the program's place one precision below what the
configuration states (TF32 for the float32 Tacotron and conditioning,
float8 e4m3 for the bfloat16 sample loop). A training cell also reads the
program with a fault planted: half of each batch left out (the mean over
the rest), and every step skipped (the state left unchanged). One JSON
line a seed on standard output.
"""
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402

import torch  # noqa: E402

from gpubench import harness, yardstick  # noqa: E402
from gpubench.reference import tacotron as ref_taco  # noqa: E402
from gpubench.reference import train as ref_train  # noqa: E402
from gpubench.reference import wavernn as ref_voc  # noqa: E402


@contextmanager
def tf32():
    """Every float32 product and convolution of torch in TF32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@torch.no_grad()
def serve_control(runner, calls):
    """The control's outputs for the calls ``runner.sample`` drew: the
    Tacotron reference in TF32, the sample loop at float8 weights, the
    serving path's crossfade, cut and fade."""
    cfg, dev = runner.cfg, runner.dev
    hop, ovl = cfg["hop_length"], cfg["voc_overlap"]
    out = []
    for rec in calls:
        call = rec["call"]
        with tf32():
            post, n_valid = ref_taco.synthesize(runner.W_tts, call["texts"],
                                                call["steps"], cfg, dev)
            mel = torch.clamp((post + 4.0) / 8.0, 0.0, 1.0)
            nf = yardstick.num_folds(call["steps"] * hop, cfg["voc_target"],
                                     ovl)
        key = ref_voc.program_seed(rec["gen_seed"])
        N = len(call["texts"])
        utts = [{"W": runner.W_voc, "mel": mel[j], "seed": key,
                 "row0": j * nf, "rows": N * nf} for j in range(N)]
        ys = ref_voc.generate(utts, cfg, ref_voc.fp8_round, dev)
        outs = []
        for j, y in enumerate(ys):
            T_valid = min(int(n_valid[j]), call["steps"])
            outs.append((ref_voc.host_wave(y, T_valid, hop, ovl),
                         mel[j, :, :T_valid].cpu().numpy()))
        out.append((call, rec["gen_seed"], outs))
    return out


def serving(spec, seed, seconds, dev):
    from gpubench.entries import tts
    runner = tts.Runner(spec["cfg"], spec["mix"], seed, dev, False, {})
    res = runner.window(seconds)
    runner.release()
    calls = runner.sample(res)
    row = {"calls": len(res["recs"]), "judged": len(calls),
           "program": runner.judge(res)}
    ctl = serve_control(runner, calls)
    row["control"] = tts.judge_calls(runner.cfg, runner.mix, runner.W_tts,
                                     runner.W_voc, ctl, dev)
    return row


def training(spec, seed, dev, controls=True):
    """The program's readings and, with ``controls``, the TF32 control's
    and those of the program with each fault planted, all against one
    reference run."""
    from gpubench.entries import train_af
    row, ref = {}, None
    for fault in ("none", "half_batch", "frozen")[:3 if controls else 1]:
        runner = _faulty(train_af.Runner, fault)(
            spec["cfg"], spec["mix"], seed, dev, False, {})
        runner.release()
        if ref is None:
            ref = ref_train.steps(runner.P0, runner.batches, runner.cfg)
        row["program" if fault == "none" else fault] = train_af.judge_steps(
            runner.cfg, runner.P0, runner.batches, runner.losses,
            runner.first, runner.change, ref)
        if fault == "none" and controls:
            with tf32():
                ctl = ref_train.steps(runner.P0, runner.batches, runner.cfg)
            row["control"] = train_af.judge_steps(
                runner.cfg, runner.P0, runner.batches, *ctl, ref=ref)
        del runner
    return row


def _faulty(base, fault):
    if fault == "none":
        return base

    class Faulty(base):
        def _step(self, b, timings):
            if fault == "frozen":
                loss = torch.zeros((), device=self.dev)
                return {"loss": loss}
            h = b["ids"].shape[0] // 2
            half = {"ids": b["ids"][:h], "mel": b["mel"][:h],
                    "aref": b["aref"][:h],
                    "masks": {k: (v[:h] if k.startswith("enc")
                                  else v[:, :h]).contiguous()
                              for k, v in b["masks"].items()}}
            return super()._step(half, timings)
    return Faulty


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--controls", type=int, default=None,
                    help="a training cell: the control and the faults on "
                    "the first this many seeds only (default: every seed)")
    args = ap.parse_args()
    harness.cache_env(harness.ROOT)
    harness.configure_torch()
    spec = harness.cell_spec(harness.load_manifest(harness.ROOT),
                             args.workload)
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t = time.time()
        if spec["mix"]["entry"] == "train_af":
            row = training(spec, seed, dev,
                           args.controls is None or i < args.controls)
        else:
            row = serving(spec, seed, args.seconds, dev)
        row.update(seed=seed, seconds=time.time() - t,
                   card=torch.cuda.get_device_name(dev))
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
