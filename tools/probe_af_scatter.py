"""The float32 gradient scatter of a full-width attention-forcing train
step on one H100: the kernel step, the plain (recurrence="scan") step and
each of them on the batch with its rows reversed (the same sums in
another order), every gradient against a float64 plain step, for the
offline (L1) and the online (KL) loss. Weights from a seed, a synthetic
dataset, one batch of 32 cut to 400 frames at r 2, reference attention
from the same model's eval TF forward. Prints per module the largest
distance from float64, the five worst decoder leaves, and how many L1
signs flip between the steps.

    python3 tools/probe_af_scatter.py  # from the root of a checkout
"""
import copy
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.config import Config, TacotronTrainConfig  # noqa: E402
from wavernn_tpu_torch.data.dataset import get_tts_datasets  # noqa: E402
from wavernn_tpu_torch.models import tacotron as taco  # noqa: E402
from wavernn_tpu_torch.train import tacotron_train as tt  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
cfg = Config()
workdir = tempfile.TemporaryDirectory()   # removed at exit
tmp = Path(workdir.name)
cs.write_tts_dataset(tmp / "data", 64, 11)
cfg_tt = Config(tts_train=TacotronTrainConfig(schedule=((2, 1e-3, 3, 32),)))
state = tt.create_train_state(cfg.tts, 80, 1e-3, 1.0, seed=13, device=dev)
model = state.model
ds, _ = get_tts_datasets(tmp / "data", 32, 2, cfg_tt, seed=3)
chars, mel_b, _, _ = next(iter(ds))
x = torch.from_numpy(chars).to(dev)
m = torch.from_numpy(mel_b[:, :, :400]).to(dev)
G = m.shape[-1] // 2
with torch.no_grad():
    aref = tt.teacher_attn_ref(model, x, m, 2)
masks = taco.draw_masks(model, x.shape[0], x.shape[1], G,
                        torch.Generator(device=dev).manual_seed(8), dev)
names = [n for n, _ in model.named_parameters()]
rev = torch.arange(x.shape[0] - 1, -1, -1, device=dev)


def flip(k, v):
    return v[:, rev] if k.startswith("dec_") or k.startswith("zm") else v[rev]


for offline, coeff in ((True, 200.0), (False, 1.0)):
    out, attn = {}, {}
    for tag, rec, dt, rv in (("kernels", "auto", torch.float32, False),
                             ("kernels_rev", "auto", torch.float32, True),
                             ("scan", "scan", torch.float32, False),
                             ("scan_rev", "scan", torch.float32, True),
                             ("scan_f64", "scan", torch.float64, False)):
        xx, mm, aa = (x[rev], m[rev], aref[rev]) if rv else (x, m, aref)
        mk = {k: (flip(k, v) if rv else v).to(dt) for k, v in masks.items()}
        loss, at, _, _, g = tt.loss_and_grads_af(
            copy.deepcopy(model).to(dt), xx, mm.to(dt), aa.to(dt), 2, coeff,
            offline, rec, mk)
        out[tag] = (float(loss), [t.double() for t in g])
        attn[tag] = (at[rev] if rv else at).double()
    res = {}
    for tag in ("kernels", "kernels_rev", "scan", "scan_rev"):
        e = {n: cs.rel_err(a, b) for n, a, b in
             zip(names, out[tag][1], out["scan_f64"][1])}
        mods = {}
        for n, v in e.items():
            mods[n.split(".")[0]] = max(mods.get(n.split(".")[0], 0.0), v)
        dec = {n: v for n, v in e.items() if n.startswith("decoder")}
        res[tag] = {"loss": out[tag][0], "modules": mods,
                    "decoder_top": sorted(dec.items(), key=lambda kv: -kv[1])[:5]}
    d = {t: attn[t] - aref.double() for t in attn}
    res["l1_sign_flips_kernels_vs_scan"] = int(
        (torch.sign(d["kernels"]) != torch.sign(d["scan"])).sum())
    res["l1_sign_flips_scan_vs_f64"] = int(
        (torch.sign(d["scan"]) != torch.sign(d["scan_f64"])).sum())
    res["attn_max_abs_kernels_vs_f64"] = float((attn["kernels"] - attn["scan_f64"]).abs().max())
    res["attn_max_abs_scan_vs_f64"] = float((attn["scan"] - attn["scan_f64"]).abs().max())
    print("offline" if offline else "online", json.dumps(res), flush=True)
