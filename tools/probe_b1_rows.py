"""B1 on the resident body in one row group against two, by row count, on
one H100: the sweep ``ops/cuda_gen.GROUP_MIN_ROWS`` comes from.

At each row count (8, 22, 32, 40, 50, 64, 80, 112, 136, 176, 216, 288 by
default) B1 runs over 8 hop-chunks (2,200 steps) at the default Config
widths in bfloat16 under the counter hash, with the plan forced to one
group and to two (the private launch's ``groups``), timed in turns (one,
two, two, one) on CUDA events; prints microseconds a step of each, the
tile rows and whether the per-row regions lie in device memory
(``rows_global``) of each plan, whether the two gave the same samples bit
for bit, and the SM clock and clock-limit reasons read around the turns.
Then the profiling instantiation's per-stage split of a step (block 0's
clock64() cycles by stage and kind, ``generate_fused_profiled``'s) at 80
rows in one group and in two, and nvcc's registers and spills of the
body's entries when this run built it. Random weights and frames from a
seed; one JSON line a result, also written to
chiprun_out/probe_b1_rows.json.

    python3 tools/probe_b1_rows.py [--rows 80 176] [--chunks 8]
    # ~3 min of command time with the build
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from wavernn_tpu_torch.config import Config  # noqa: E402
from wavernn_tpu_torch.models import wavernn as wr  # noqa: E402
from wavernn_tpu_torch.ops import _build, polyphase  # noqa: E402
from wavernn_tpu_torch.ops import cuda_gen as cg  # noqa: E402

ROWS = (8, 22, 32, 40, 50, 64, 80, 112, 136, 176, 216, 288)
OUT = Path("chiprun_out") / "probe_b1_rows.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--split_rows", type=int, default=80)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_b1_rows needs a CUDA device")
    dev = torch.device("cuda")
    results = []

    def emit(**fields):
        results.append(fields)
        print(json.dumps(fields), flush=True)

    emit(card=cs.smi_line(), sms=torch.cuda.get_device_properties(
        dev).multi_processor_count)
    job = _build._start("sample_loop_resident")
    if job is not None:
        log = _build._finish("sample_loop_resident", job)
        emit(ptxas=[ln.split("info    : ")[-1].strip()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln])
    cfg = Config()
    gen = torch.Generator().manual_seed(2020)
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.reset_parameters(gen)
    core = voc.to(dev).eval().core_weights()
    geo = polyphase.geometry(cfg.voc.upsample_factors, cfg.voc.pad)
    R, FC = cfg.voc.rnn_dims, cfg.voc.fc_dims
    A, n_mels = cfg.voc.res_out_dims // 4, cfg.dsp.num_mels
    NC = core["fc3.weight"].shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    phi = torch.rand(geo.K, geo.hop, generator=gen).to(dev)
    bf = torch.bfloat16
    steps = opt.chunks * geo.hop

    def frames(B, chunks):
        return torch.rand(chunks + geo.K - 1, B, n_mels + 4 * A,
                          generator=gen).to(dev)

    def launch(fr, chunks, groups, prof=None):
        return cg._fused_launch(core, fr, phi, geo.hop, -geo.d_lo, chunks,
                                cfg.voc.mode, None, 5, bf, None, None, True,
                                prof, groups=groups)

    with torch.no_grad():
        for B in opt.rows:
            plans = {g: cg.resident_plan(R, FC, NC, A, n_mels, B, sms, bf,
                                         geo.K, groups=g) for g in (1, 2)}
            fr = frames(B, opt.chunks)
            t = cs.turns(lambda: launch(fr, opt.chunks, 2),
                         lambda: launch(fr, opt.chunks, 1), 2,
                         1e3 / steps, cs.same_out)
            emit(rows=B, us_per_step_one=t["old"], us_per_step_two=t["new"],
                 two_over_one=min(t["new"]) / min(t["old"]),
                 two_faster=t["new_faster"], equal=t["equal"],
                 rule=cg.resident_plan(R, FC, NC, A, n_mels, B, sms, bf,
                                       geo.K).groups,
                 tile_rows={g: p.tile_rows for g, p in plans.items()},
                 rows_global={g: p.rows_global for g, p in plans.items()},
                 clocks=t["clocks"])
        clock = cs.gpu_clocks()
        mhz = float(clock.split(" MHz")[0]) if " MHz" in clock else None
        fr = frames(opt.split_rows, 8)
        for g in (1, 2):
            prof = cg._prof_buffer(dev)
            launch(fr, 8, g, prof)
            cyc, n = cg._prof_split(prof)
            split = {st: {k: v / n for k, v in kinds.items()}
                     for st, kinds in cyc.items() if st != "prologue"}
            total = sum(sum(k.values()) for k in split.values())
            emit(split_rows=opt.split_rows, groups=g,
                 cycles_per_step=split, step_cycles=total,
                 step_us_at_sm_clock=total / mhz if mhz else None,
                 sm_clock=clock)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
