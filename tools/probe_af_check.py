"""How often chip_smoke's Tacotron kernels-vs-scan rule fails when
nothing is wrong, on one H100. The float32 kernel step and the float32
plain (recurrence="scan") step each run on the same batch in several row
orders (the gradients are sums over rows, so each order is the same sums
rounded another way). Every gradient is held to float64 in two ways:

  one    one float64 plain step on its own branches (the rule before
         ``chip_smoke.branch_grads``);
  branch a float64 plain step on the float32 step's branches at each
         ReLU, max-pool and L1 term outside the decoder recurrence, so the
         two take the same subgradient (chip_smoke's rule now).

For each kernel order, the rule (distance from float64 within max(1e-4,
twice the larger distance of two float32 plain orders, per module)) is
evaluated against every pair of plain orders; so is each plain order
against every pair of the others, which no kernel touches. Also printed:
the count of branches each float64 step took from its float32 step
against its own.

Weights from a seed, a synthetic dataset of 64 items, one batch of 32:
AF-offline cut to 400 frames at r 2 with reference attention from the
same model's eval TF forward (chip_smoke's taco_af shape), and teacher
forcing on the whole batch at r 7 (its taco_train shape); injected
dropout and zoneout masks.

    python3 tools/probe_af_check.py [n_orders]  # from a checkout's root
"""
import copy
import itertools
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
n_orders = int(sys.argv[1]) if len(sys.argv) > 1 else 4
cfg = Config()
workdir = tempfile.TemporaryDirectory()   # removed at exit
tmp = Path(workdir.name)
cs.write_tts_dataset(tmp / "data", cs.TT_ITEMS, 11)
cfg_tt = Config(tts_train=TacotronTrainConfig(schedule=((2, 1e-3, 3, 32),)))
model = tt.create_train_state(cfg.tts, 80, 1e-3, 1.0, seed=13,
                              device=dev).model
names = [n for n, _ in model.named_parameters()]
module = lambda n: n.split(".")[0]
mods = sorted({module(n) for n in names})


def case(r, frames, mode, coeff):
    ds, _ = get_tts_datasets(tmp / "data", 32, r, cfg_tt, seed=3)
    chars, mel_b = next(iter(ds))[:2]
    x = torch.from_numpy(chars).to(dev)
    m = torch.from_numpy(mel_b[:, :, :frames]).to(dev)
    G = m.shape[-1] // r
    aref = None
    if mode == "attention_forcing_offline":
        with torch.no_grad():
            aref = tt.teacher_attn_ref(model, x, m, r)
    masks = taco.draw_masks(model, x.shape[0], x.shape[1], G,
                            torch.Generator(device=dev).manual_seed(8), dev)
    B = x.shape[0]
    orders = [torch.arange(B, device=dev),
              torch.arange(B - 1, -1, -1, device=dev)]
    for k in range(2, n_orders):
        orders.append(torch.randperm(B, generator=torch.Generator()
                                     .manual_seed(k)).to(dev))

    def inputs(p):
        return lambda dt: (
            x[p], m[p].to(dt),
            {k: (v[:, p] if k[:3] in ("dec", "zm1", "zm2") else v[p]).to(dt)
             for k, v in masks.items()},
            None if aref is None else aref[p].to(dt))

    x64, m64, masks64, aref64 = inputs(orders[0])(torch.float64)
    one = cs.branch_grads(copy.deepcopy(model).to(torch.float64), x64, m64,
                          r, "scan", masks64, mode, aref64, coeff)[1]
    res = {"kernels": [], "scan": []}
    for tag, rec in (("kernels", "auto"), ("scan", "scan")):
        for i, p in enumerate(orders):
            out = cs.branch_steps(model, {tag: (rec, inputs(p))}, mode, r,
                                  coeff=coeff)
            _, g, g64 = out[tag]
            e = {"one": {n: cs.rel_err(a, b) for n, a, b in
                         zip(names, g, one)},
                 "branch": {n: cs.rel_err(a, b) for n, a, b in
                            zip(names, g, g64)}}
            per_mod = {k: {md: max(v for n, v in ek.items()
                                   if module(n) == md) for md in mods}
                       for k, ek in e.items()}
            res[tag].append(e)
            print(json.dumps({"mode": mode, "path": tag, "order": i,
                              "module": per_mod,
                              "branch_flips": out["branch_flips"][tag]}),
                  flush=True)

    summary = {}
    for rule in ("one", "branch"):
        for tag in ("kernels", "scan"):
            n_runs = n_fail = 0
            failing = {}
            for i, c in enumerate(res[tag]):
                for a, b in itertools.combinations(range(len(orders)), 2):
                    if tag == "scan" and i in (a, b):
                        continue
                    limit = {md: max(cs.B6_TOL, 2 * max(
                        res["scan"][j][rule][n] for j in (a, b)
                        for n in names if module(n) == md)) for md in mods}
                    bad = [n for n in names if c[rule][n] > limit[module(n)]]
                    n_runs += 1
                    n_fail += bool(bad)
                    for n in bad:
                        failing[n] = failing.get(n, 0) + 1
            summary[f"{rule}_{tag}"] = {"evaluations": n_runs,
                                        "failures": n_fail,
                                        "failing_leaves": failing}
        summary[f"{rule}_module_max"] = {
            tag: {md: max(max(v for n, v in c[rule].items()
                              if module(n) == md) for c in res[tag])
                  for md in mods} for tag in res}
    print("summary", mode, json.dumps(summary), flush=True)


case(2, cs.AF_FRAMES, "attention_forcing_offline", 200.0)
case(7, None, "teacher_forcing", 0.0)
