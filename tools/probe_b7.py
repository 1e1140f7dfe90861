"""Quick check of kernel B7 on one H100, shorter than chip_smoke.py:
build every kernel (printing ptxas's registers and spills for
csrc/taco_train.cu), hold B7 against its plain versions at the odd shape
(train and eval masks) and at full width (B 32, T_text 150, 200 groups,
r 2), then time B6 at chip_smoke's b6 shape and B7 at that full width,
twice each.

    python3 tools/probe_b7.py          # from the root of a checkout
"""
import json
import sys
import time
import traceback

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.ops import _build  # noqa: E402
from wavernn_tpu_torch.ops import cuda_taco_train as ct  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
print(cs.smi_line(), flush=True)
t = time.time()
logs = _build.build_all()
print("build_s", time.time() - t, flush=True)
for ln in logs.get("taco_train", "").splitlines():
    if "registers" in ln or "spill" in ln or "Function properties" in ln:
        print(ln.strip())
for tag, shape, train in (("odd", (5, 33, 7, 2), True),
                          ("odd_eval", (5, 33, 7, 2), False),
                          ("full", (32, 150, 200, 2), True)):
    try:
        ins, w = cs.b7_case(*shape, dev, 41, train)
        with torch.no_grad():
            res, ok = cs.check_b7(ct, ins, w, 42, backward=train)
        print(tag, ok, json.dumps(res), flush=True)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
try:
    ins6, w6 = cs.b6_case(*cs.B6_FULL, dev, 31, True)
    ins7, w7 = cs.b7_case(32, 150, 200, 2, dev, 31, True)
    with torch.no_grad():
        for rep in range(2):
            f6, (mel6, sc6, st6) = cs.cuda_ms(
                lambda: ct.decoder_tf_fwd(*ins6, w6, save=True), 3)
            d6 = torch.randn_like(mel6), torch.randn_like(sc6)
            b6, _ = cs.cuda_ms(lambda: ct.decoder_tf_bwd(
                *d6, st6, sc6, *ins6, w6), 3)
            f7, (mel7, sc7, st7) = cs.cuda_ms(
                lambda: ct.decoder_af_fwd(*ins7, w7, save=True), 3)
            d7 = torch.randn_like(mel7), torch.randn_like(sc7)
            b7, _ = cs.cuda_ms(lambda: ct.decoder_af_bwd(
                *d7, st7, sc7, *ins7, w7), 3)
            print("times_ms", json.dumps({"b6_fwd": f6, "b6_bwd": b6,
                                          "b7_fwd": f7, "b7_bwd": b7}),
                  flush=True)
except Exception:
    traceback.print_exc()
