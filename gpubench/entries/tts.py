"""Serving: a closed loop of one client through the program's text-to-wave
entries, ``synthesis.tts_to_wav_batch`` (a mix's ``batch`` > 1) or
``synthesis.tts_to_wav_fast`` (``batch`` 1). Each call returns its waves
on the host; the next call starts when it has.

The check: after the window, the calls drawn from the seed (the one with
the longest text among them) are decoded again by the plain Tacotron and
their waves followed step by step by the plain WaveRNN
(``reference.wavernn.judge``), conditioned on the served mel.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from .. import traffic, weights, yardstick
from ..reference import tacotron as ref_taco
from ..reference import wavernn as ref_voc
from .common import build, port_config

# a reading for a request the check could not follow (no such gap occurs)
UNJUDGED = 1e9


class Runner:
    def __init__(self, cfg, mix, seed, device, trace, split):
        t = time.time()
        from wavernn_tpu_torch import synthesis
        from wavernn_tpu_torch.models import tacotron as taco
        from wavernn_tpu_torch.models import wavernn as wr
        split["import_s"] = time.time() - t
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.trace, self.synthesis = trace, synthesis
        self.pcfg = port_config(cfg)
        self.r = cfg["tts_r"]
        if device.type == "cuda":
            build(split)
        t = time.time()
        gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
        with torch.device(device):
            self.tts = taco.Tacotron(self.pcfg.tts, cfg["num_mels"])
            self.voc = wr.WaveRNN(self.pcfg.voc, self.pcfg.dsp)
        self.W_tts = weights.fill(self.tts, weights.tacotron_rule, gen)
        self.W_voc = weights.fill(self.voc, weights.wavernn_rule, gen)
        self.calls = traffic.tts_calls(mix, seed, self.r)
        split["weights_s"] = time.time() - t
        t = time.time()
        # one pass of the mix: every shape the window uses (the first call
        # of a new text or mel length sets up cuDNN's convolutions on the
        # host), the largest allocations, every kernel library
        for c in self.calls:
            self._call(c, torch.Generator().manual_seed(0),
                       {} if trace else None)
        self._sync()
        split["warmup_s"] = time.time() - t

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _call(self, c, gen, timings):
        """One request: a list of (wave float32 numpy, mel (n_mels, T))."""
        s = self.synthesis
        if self.mix["batch"] == 1:
            return [s.tts_to_wav_fast(self.tts, self.voc, c["texts"][0],
                                      self.pcfg, self.r, steps=c["steps"],
                                      generator=gen, device=self.dev,
                                      timings=timings)]
        return s.tts_to_wav_batch(self.tts, self.voc, c["texts"], self.pcfg,
                                  self.r, steps=c["steps"], generator=gen,
                                  device=self.dev, timings=timings)

    def window(self, seconds: float) -> dict:
        """Whole passes of the mix, back to back, until ``seconds`` have
        passed: every seed's window holds the same calls."""
        timings = {} if self.trace else None
        recs, failed = [], 0
        t0 = time.perf_counter()
        t_end = t0
        i = 0
        while t_end - t0 < seconds:
            for c in self.calls:
                gs = traffic.call_seed(self.seed, i)
                ta = time.perf_counter()
                try:
                    outs = self._call(c, torch.Generator().manual_seed(gs),
                                      timings)
                except Exception:   # a failed request is counted, not fatal
                    traceback.print_exc()
                    failed, outs = failed + 1, None
                t_end = time.perf_counter()
                recs.append({"call": c, "gen_seed": gs,
                             "ms": 1e3 * (t_end - ta), "outs": outs})
                i += 1
        n = len(self.calls)
        if len(recs) >= 2 * n:
            # a shape that warmed up in the window would show here
            first = max(recs[j]["ms"] / recs[n + j]["ms"] for j in range(n))
            print(f"window: {len(recs) // n} passes of {n} calls; slowest "
                  f"first-pass call / its second {first:.4f}",
                  file=sys.stderr)
        res = {"window_s": t_end - t0, "attempted": i, "failed": failed,
               "recs": recs, "calls": self._shapes(recs)}
        if timings is not None and self.dev.type == "cuda":
            from wavernn_tpu_torch.timing import elapsed_ms
            self._sync()
            res["stage_ms"] = elapsed_ms(timings)
        return res

    def _shapes(self, recs):
        """The work of each completed call, for the per-layer readers: each
        utterance's symbols and served frames, and the folds its audio
        needs."""
        hop, tgt, ovl = (self.cfg["hop_length"], self.cfg["voc_target"],
                         self.cfg["voc_overlap"])
        out = []
        for rec in recs:
            if rec["outs"] is None:
                continue
            utts = [{"T_text": len(t), "frames": m.shape[1]}
                    for t, (_, m) in zip(rec["call"]["texts"], rec["outs"])]
            out.append({"utts": utts, "steps": rec["call"]["steps"],
                        "folds": sum(yardstick.num_folds(u["frames"] * hop,
                                                         tgt, ovl)
                                     for u in utts)})
        return out

    def end_to_end(self, res) -> dict:
        sr = self.cfg["sample_rate"]
        done = [r for r in res["recs"] if r["outs"] is not None]
        audio = sum(len(w) for r in done for w, _ in r["outs"]) / sr
        ms = [r["ms"] for r in res["recs"]]
        return {"audio_s_per_s": audio / res["window_s"],
                "request_ms_p90": float(np.percentile(ms, 90))}

    def release(self):
        del self.tts, self.voc
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, res):
        """The completed calls the check reads: the one with the longest
        text, and others drawn from the seed."""
        done = [i for i, r in enumerate(res["recs"]) if r["outs"] is not None]
        if not done:
            return []
        longest = max(done, key=lambda i: (res["recs"][i]["call"]["steps"],
                                           -i))
        rest = [i for i in done if i != longest]
        k = min(len(rest), self.mix["judge_calls"] - 1)
        pick = traffic.rng(self.seed, 4).choice(len(rest), k, replace=False)
        return [res["recs"][longest]] + [res["recs"][rest[j]] for j in pick]

    def judge(self, res) -> dict:
        recs = self.sample(res)
        if not recs:
            return {"mel_gap": UNJUDGED, "sample_gap": UNJUDGED}
        return judge_calls(self.cfg, self.mix, self.W_tts, self.W_voc,
                           [(r["call"], r["gen_seed"], r["outs"])
                            for r in recs], self.dev)


def judge_calls(cfg, mix, W_tts, W_voc, calls, dev):
    """The check of served calls, each (call, its generator seed, its
    outputs [(wave, mel)]): the widest gap of a served mel from the plain
    decode, and of a served sample from the plain vocoder followed on the
    served mel and samples."""
    hop = cfg["hop_length"]
    mel_gap, utts = 0.0, []
    for call, gs, outs in calls:
        with torch.no_grad():
            post, n_valid = ref_taco.synthesize(W_tts, call["texts"],
                                                call["steps"], cfg, dev)
        mel_ref = torch.clamp((post + 4.0) / 8.0, 0.0, 1.0)
        key = ref_voc.program_seed(gs)
        nf = yardstick.num_folds(call["steps"] * hop, cfg["voc_target"],
                                 cfg["voc_overlap"])
        for j, (wave, mel) in enumerate(outs):
            T_valid = mel.shape[1]
            if T_valid != min(int(n_valid[j]), call["steps"]):
                mel_gap = UNJUDGED
                continue
            m = torch.as_tensor(mel, device=dev)
            mel_gap = max(mel_gap, float((m - mel_ref[j, :, :T_valid])
                                         .abs().max()))
            if T_valid != call["steps"]:
                # a decode that stopped early vocodes a bucket-padded mel
                # that the call does not return: its folds are unknown
                mel_gap = UNJUDGED
                continue
            utts.append({"W": W_voc, "mel": m, "wave": wave,
                         "T_valid": T_valid, "seed": key, "row0": j * nf,
                         "rows": len(outs) * nf})
    if not utts:
        return {"mel_gap": mel_gap, "sample_gap": UNJUDGED}
    gap, count = ref_voc.judge(utts, cfg, mix["judge_margin"], dev)
    print(f"judge: {len(calls)} calls, {len(utts)} utterances, "
        f"{count} samples compared", file=sys.stderr)
    return {"mel_gap": mel_gap, "sample_gap": gap if count else UNJUDGED}
