"""Training: ``train.tacotron_train.train_step_af(offline=True)`` on four
batches that the benchmark made from the seed and padded as the upstream
collate pads them (``traffic.collate``), held on the device and cycled;
every dropout and zoneout mask drawn by the benchmark and handed to the
step.

Set-up builds the one training state and runs its first four steps, one
on each batch (the check's readings: each step's loss, the first step's
gradients as the optimizer holds them, the parameters' change over the
four), and hands the same state to the window. The check repeats the
four steps with the plain reference (``reference.train``) from the
weights and the batches the benchmark made.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from .. import traffic, weights
from ..reference import train as ref_train
from ..reference.tacotron import text_ids
from .common import build, port_config


class Runner:
    def __init__(self, cfg, mix, seed, device, trace, split):
        t = time.time()
        from wavernn_tpu_torch.models import tacotron as taco
        from wavernn_tpu_torch.train import tacotron_train as tt
        from wavernn_tpu_torch.train.wavernn_train import make_optimizer
        split["import_s"] = time.time() - t
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.trace, self.tt = trace, tt
        self.r = r = cfg["tts_r"]
        pcfg = port_config(cfg, "attention_forcing_offline")
        if device.type == "cuda":
            build(split)
        t = time.time()
        gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
        with torch.device(device):
            model = taco.Tacotron(pcfg.tts, cfg["num_mels"])
        self._sync()
        split["model_s"] = time.time() - t
        t = time.time()
        model.decoder.r.fill_(r)
        self.P0 = weights.fill(model, weights.tacotron_rule, gen)
        self._sync()
        split["weights_s"] = time.time() - t
        t = time.time()
        # torch.optim's first optimizer imports torch._dynamo
        self.state = tt.TTSTrainState(
            model, make_optimizer(model, cfg["tts_lr"],
                                  cfg["tts_clip_grad_norm"]), 0)
        split["optimizer_s"] = time.time() - t
        t = time.time()
        self.batches = []
        for _, items in traffic.train_items(mix, seed, r):
            chars, mel, aref = traffic.collate(items, r, text_ids)
            b = {"ids": torch.as_tensor(chars, device=device),
                 "mel": torch.as_tensor(mel, device=device),
                 "aref": torch.as_tensor(aref, device=device)}
            b["masks"] = self._masks(b, gen, pcfg.tts)
            self.batches.append(b)
        self._sync()
        split["data_s"] = time.time() - t
        t = time.time()
        names = [k for k, _ in model.named_parameters()]
        self.losses = []
        for k, b in enumerate(self.batches):
            out = self._step(b, None)
            self.losses.append(out["loss"])
            if k == 0:
                st = self.state.opt.adam.state
                # Adam's first moment after one step is (1 - b1) g
                self.first = {n: float(torch.linalg.vector_norm(
                    st[p]["exp_avg"]) / (1 - 0.9)) if p in st else 0.0
                    for n, p in zip(names, model.parameters())}
        self.losses = [float(x) for x in self.losses]
        self.change = {n: float(torch.linalg.vector_norm(p.detach()
                                                         - self.P0[n]))
                       for n, p in model.named_parameters()}
        self._sync()
        split["first_steps_s"] = time.time() - t

    def _masks(self, b, gen, tts):
        """The step's random draws: the prenets' keep-masks scaled by
        1 / (1 - dropout), the LSTMs' zoneout keep-previous masks (0.1)."""
        B, T = b["ids"].shape
        G = b["mel"].shape[2] // self.r
        P1, P2, L = 256, 128, tts.lstm_dims
        keep = 1.0 - tts.dropout

        def drop(*shape):
            u = torch.rand(shape, generator=gen, device=self.dev)
            return (u < keep).float() / keep

        def zone(*shape):
            u = torch.rand(shape, generator=gen, device=self.dev)
            return (u < 0.1).float()
        return {"enc_drop1": drop(B, T, P1), "enc_drop2": drop(B, T, P2),
                "dec_drop1": drop(G, B, P1), "dec_drop2": drop(G, B, P2),
                "zm1": zone(G, B, L), "zm2": zone(G, B, L)}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self, b, timings):
        return self.tt.train_step_af(
            self.state, b["ids"], b["mel"], b["aref"], self.r,
            attn_loss_coeff=self.cfg["attn_loss_coeff"], offline=True,
            masks=b["masks"], timings=timings)

    def window(self, seconds: float) -> dict:
        timings = {} if self.trace else None
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            for b in self.batches:        # whole cycles of the batches
                self._step(b, timings)
                n += 1
        self._sync()
        res = {"window_s": time.perf_counter() - t0, "attempted": n,
               "failed": 0,
               "calls": [{"B": self.batches[i % 4]["ids"].shape[0],
                          "T_text": self.batches[i % 4]["ids"].shape[1],
                          "frames": self.batches[i % 4]["mel"].shape[2],
                          "r": self.r} for i in range(n)]}
        if timings is not None and self.dev.type == "cuda":
            from wavernn_tpu_torch.timing import elapsed_ms
            res["stage_ms"] = elapsed_ms(timings)
        return res

    def end_to_end(self, res) -> dict:
        return {"train_steps_per_s": res["attempted"] / res["window_s"]}

    def release(self):
        del self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, res) -> dict:
        return judge_steps(self.cfg, self.P0, self.batches, self.losses,
                           self.first, self.change)


def judge_steps(cfg, P0, batches, losses, first, change, ref=None):
    """The program's steps, one a batch, against the reference's (``ref``,
    its ``steps`` of them, where already made): the widest relative gap of
    a step's loss; of a leaf's norm of the first clipped gradient; of a
    leaf's norm of the change over all the steps. A
    leaf's gap is measured against its reference norm or the median
    leaf's, whichever is larger; leaves whose reference gradient is under
    a thousandth of the median leaf's (moved by round-off alone under
    Adam) are left out of the change."""
    r_losses, r_first, r_change = (ref_train.steps(P0, batches, cfg)
                                   if ref is None else ref)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    med_g = statistics.median(r_first.values())
    grad = {k: abs(first[k] - g) / max(g, med_g) for k, g in r_first.items()}
    kept = [k for k, g in r_first.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(r_change[k] for k in kept)
    change = {k: abs(change[k] - r_change[k]) / max(r_change[k], med_c)
              for k in kept}
    wg, wc = max(grad, key=grad.get), max(change, key=change.get)
    print(f"judge: worst gradient leaf {wg} ({r_first[wg]:.4g} of median "
          f"{med_g:.4g}), worst change leaf {wc} ({r_change[wc]:.4g} of "
          f"median {med_c:.4g}); {len(r_first) - len(kept)} leaves left out",
          file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": grad[wg],
            "change_gap": change[wc]}
