"""Vocoder training: ``train.wavernn_train.train_step`` (float32, the
GRUs on B5) on four batches of ``voc_batch_size`` windows of
``voc_seq_len`` samples, cut by the benchmark from seeded utterances as
the upstream collate cuts them (``traffic.collate_voc``), held on the
device and cycled.

Set-up builds the one training state and runs its first four steps, one
on each batch (the check's readings: each step's loss, the first step's
gradients as the optimizer holds them, the parameters' change over the
four), and hands the same state to the window. The check repeats the
four steps with the plain reference (``reference.train_voc``), in
float64, from the weights and the batches the benchmark made.
"""
from __future__ import annotations

import time

import torch

from .. import traffic, weights
from ..reference import train_voc as ref_voc
from ..trace import StageMarks
from .common import build, first_steps, judge_steps, port_config, tf32

# the CPU cut (gpubench/tests/tiny.py): two windows of one hop a batch
TINY_MIX = {"frames": [16, 19, 23]}
TINY_CFG = {"voc_batch_size": 2, "voc_seq_len": 275}


class Runner:
    def __init__(self, cfg, mix, seed, device, trace, split):
        t = time.time()
        from wavernn_tpu_torch.models import wavernn as wr
        from wavernn_tpu_torch.train import wavernn_train as wt
        split["import_s"] = time.time() - t
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.trace, self.wt = trace, wt
        pcfg = port_config(cfg)
        self.voc = pcfg.voc
        if device.type == "cuda":
            build(split)
        t = time.time()
        gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
        with torch.device(device):
            model = wr.WaveRNN(pcfg.voc, pcfg.dsp)
        self.P0 = weights.fill(model, weights.wavernn_rule, gen)
        self._sync()
        split["weights_s"] = time.time() - t
        t = time.time()
        # torch.optim's first optimizer imports torch._dynamo
        self.state = wt.TrainState(
            model, wt.make_optimizer(model, cfg["voc_lr"],
                                     cfg["voc_clip_grad_norm"]), 0)
        split["optimizer_s"] = time.time() - t
        t = time.time()
        crops = traffic.crop_rng(seed)
        bits = 16 if cfg["voc_mode"] == "MOL" else cfg["bits"]
        self.batches = []
        for items in traffic.voc_items(mix, seed, cfg):
            x, y, mels = traffic.collate_voc(
                items, cfg["hop_length"], cfg["voc_seq_len"], cfg["voc_pad"],
                bits, cfg["voc_mode"], crops)
            self.batches.append({"x": torch.as_tensor(x, device=device),
                                 "y": torch.as_tensor(y, device=device),
                                 "mels": torch.as_tensor(mels,
                                                         device=device)})
        self._sync()
        split["data_s"] = time.time() - t
        t = time.time()
        self.losses, self.first, self.change = first_steps(
            self._step, self.batches, model, self.state.opt, self.P0)
        self._sync()
        split["first_steps_s"] = time.time() - t

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self, b, timings):
        return self.wt.train_step(self.state, b["x"], b["y"], b["mels"],
                                  self.voc, timings=timings)

    def window(self, seconds: float) -> dict:
        # traced runs mark each stage's close in the trace (trace.py)
        timings = StageMarks() if self.trace else None
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            for b in self.batches:        # whole cycles of the batches
                self._step(b, timings)
                n += 1
        self._sync()
        B, T = self.batches[0]["x"].shape
        res = {"window_s": time.perf_counter() - t0, "attempted": n,
               "failed": 0, "calls": [{"B": B, "T": T}] * n}
        return res

    def end_to_end(self, res) -> dict:
        return {"train_steps_per_s": res["attempted"] / res["window_s"]}

    def release(self):
        del self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self):
        """The plain reference's steps from the same weights and batches,
        in float64: the program's float32 is held to the exact steps, so
        the TF32 control's gaps stand farther from its own."""
        def wide(d):
            return {k: v.double() if v.is_floating_point() else v
                    for k, v in d.items()}
        return ref_voc.steps(wide(self.P0), [wide(b) for b in self.batches],
                             self.cfg)

    def control(self):
        """The reference's steps one precision below float32: TF32."""
        with tf32():
            return ref_voc.steps(self.P0, self.batches, self.cfg)

    def judge(self, res) -> dict:
        return judge_steps(self.losses, self.first, self.change,
                           self.reference())
