"""Per-stage cycle split of kernel B6's original body (csrc/taco_train.cu,
the TF arm: taco_tf_fwd / taco_tf_bwd) on one H100.

The original body's two arms share one templated body per direction, so
the profiling copy of csrc/taco_train.cu that tools/probe_b7_split.py
builds (clock64() at every stage boundary, summed over all groups on block
0, which owns utterance 0's attention, and on the grid's last block, which
owns none at B 32) profiles the TF arm too; its AF-only stamps (the prenet
in the forward, the prenet's backward) stay at zero here. Prints cycles per
group for each interval, the SM clock read with nvidia-smi around the runs,
and the original body's times at the same shape before and after.

    python3 tools/probe_b6_split.py            # b6 full shape: B 32,
                                               # T_text 150, 100 groups, r 7
"""
import ctypes
import json
import sys
import time

import torch

sys.path.insert(0, ".")
sys.path.insert(0, "tools")
import chip_smoke as cs  # noqa: E402
import probe_b7_split as p7  # noqa: E402
from wavernn_tpu_torch.ops import _build  # noqa: E402
from wavernn_tpu_torch.ops import cuda_taco_train as ct  # noqa: E402

# the TF arm's stamps: the AF-only ones dropped
FWD = [k for k in p7.FWD if not k.startswith("prenet")]
BWD = [k for k in p7.BWD if k != "s5_prenet_bwd"]


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    B, T, G, r = cs.B6_FULL
    ins, w = cs.b6_case(B, T, G, r, dev, 31, True)
    host = (ctypes.c_ulonglong * 128)()
    out = {"shape": {"B": B, "T_text": T, "G": G, "r": r}}
    fwd = lambda: ct.decoder_tf_fwd(*ins, w, save=True, _legacy=True)
    with torch.no_grad():
        mel, sc, st = fwd()
        dmel, dsc = torch.randn_like(mel), torch.randn_like(sc)
        bwd = lambda: ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w,
                                        _legacy=True)
        clk = [cs.gpu_clocks()]
        out["original_ms"] = {"fwd": cs.cuda_ms(fwd, 3)[0],
                              "bwd": cs.cuda_ms(bwd, 3)[0]}
        lib = p7.build()
        lib.wr_prof_read.argtypes = [ctypes.c_void_p]
        _build._libs["taco_train"] = lib
        fwd()   # warm-up
        bwd()
        torch.cuda.synchronize()
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            lib.wr_prof_reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lib.wr_prof_read(host)
            labels, all_labels, base = ((FWD, p7.FWD, 0) if name == "fwd"
                                        else (BWD, p7.BWD, p7.B0))
            per = {}
            for blk, tag in ((0, "block0"), (1, "last_block")):
                per[tag] = {lab: host[blk * 64 + base + all_labels.index(lab)]
                            / G for lab in labels}
                per[tag]["total"] = sum(per[tag][lab] for lab in labels)
            out[name] = {"cycles_per_group": per,
                         "wall_ms_profiled": 1e3 * wall}
        clk.append(cs.gpu_clocks())
        out["clocks"] = clk
        out["profiled_copy_ms"] = {"fwd": cs.cuda_ms(fwd, 3)[0],
                                   "bwd": cs.cuda_ms(bwd, 3)[0]}
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
