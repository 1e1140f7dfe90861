"""One run of one cell: set-up, the measured window, the metrics, the
check of the outputs against the plain reference, and the result line.

The cell's configuration, traffic mix, limits and per-layer metrics are
files found by the names ``BENCHMARK.json`` gives; the traffic mix names
the entry module (``entries/<entry>.py``) that drives the program.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "wavernn_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the wall clock (from /proc; the harness's
    own import time where that cannot be read)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime"):
                return int(line.split()[1]) + start
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def cache_env(root: Path) -> None:
    """Every kernel cache of the program at a fixed path in the checkout
    (the port builds its CUDA libraries into wavernn_tpu_torch/_build/)."""
    cache = root / "gpubench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def configure_torch(threads: int = 4) -> None:
    """float32 as the configurations state it (TF32 off), and a few host
    threads, so that one process loads one card steadily."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(threads)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, name: str, root: Path = ROOT) -> dict:
    """Everything a run of the cell ``name`` reads: its manifest entry, its
    configuration, traffic mix, limits and metric specifications."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "gpubench" / "workloads"
                      / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "gpubench" / "limits"
                         / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "cfg": cfg, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": layer, "root": root}


def entry_module(root: Path, name: str):
    """The entry module ``entries/<name>.py`` of the checkout at ``root``
    (a copy of the benchmark that adds an entry loads it from its own
    files; the harness's modules it imports are this checkout's)."""
    modname = f"gpubench.entries.{name}"
    if Path(root).resolve() == ROOT:
        return importlib.import_module(modname)
    spec = importlib.util.spec_from_file_location(
        modname, Path(root) / "gpubench" / "entries" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The ``read(ctx)`` of the per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = root / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class LayerContext:
    """What a per-layer reader reads: the configuration and mix, the
    window, the trace's device seconds (in all, by kernel, and by program
    stage where the entry marks its stages with ``trace.StageMarks``), the
    program's stage milliseconds (its ``timings=`` CUDA events), the shapes
    of the work completed and the program's counters over the window
    (``{}`` where the entry reads none)."""

    def __init__(self, cfg, mix, window_s, traced, stage_ms, calls,
                 counters=None):
        self.cfg, self.mix, self.window_s = cfg, mix, window_s
        self.busy_s = traced["busy_s"] if traced else None
        self.kernels = traced["kernels"] if traced else {}
        stages = traced.get("stages") if traced else None
        self.stage_s = stages[0] if stages else {}
        self.stage_ms, self.calls = stage_ms, calls
        self.counters = counters or {}

    def kernel_s(self, *parts) -> float:
        """Device seconds of the kernels whose name holds one of ``parts``."""
        return sum(s for n, s in self.kernels.items()
                   if any(p in n for p in parts))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, entry_patch=None):
    """One run: returns (result dict, check lines). ``entry_patch`` (tests)
    is called with the entry module before set-up, to break the timed path
    underneath."""
    import torch
    from . import trace as tr
    configure_torch()
    mix, cfg = spec["mix"], spec["cfg"]
    entry = entry_module(spec["root"], mix["entry"])
    if entry_patch is not None:
        entry_patch(entry)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    split = {}
    runner = entry.Runner(cfg, mix, seed, device, trace, split)
    setup_s = time.time() - t_start
    log("setup " + json.dumps({k: round(v, 3) for k, v in split.items()})
        + f" total {setup_s:.3f} s")
    traced = None
    # the program's counters, read on the host just before and just after
    # the window (nothing is called inside it)
    read_counters = getattr(runner, "counters", dict)
    before = read_counters()
    if trace:
        with tr.profiled(device.type) as h:
            res = runner.window(seconds)
    else:
        res = runner.window(seconds)
    counted = {k: v - before.get(k, 0) for k, v in read_counters().items()}
    if counted:
        log("counters " + json.dumps(counted))
    if trace and device.type == "cuda":
        traced = tr.reduce(h.prof, res["window_s"])
        if traced["stages"]:
            by, lost = traced["stages"]
            log("stage device s " + json.dumps(by)
                + f" unattributed {lost!r} busy {traced['busy_s']!r}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics = {}
    if trace:
        ctx = LayerContext(cfg, mix, res["window_s"], traced,
                           res.get("stage_ms", {}), res["calls"], counted)
        for m in spec["per_layer"]:
            v = reader(spec["root"], m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = runner.end_to_end(res)
        e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    runner.release()
    readings = runner.judge(res)
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in spec["limits"].items()}
    correct = (res["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        line["breakdown"] = traced["breakdown"]
    line["checks"] = checks
    return line, [f"check {k} {c['value']!r} limit {c['limit']!r}"
                  for k, c in checks.items()]


def main(argv=None, t_start=None) -> int:
    t_start = process_start() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = cell_spec(load_manifest(ROOT), args.workload)
    except (OSError, StopIteration, ValueError) as e:
        log(f"gpubench: cannot load cell {args.workload!r}: {e!r}")
        return 2
    cache_env(ROOT)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"gpubench: the cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        line, checks = run_cell(spec, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                t_start)
    except Exception:
        log(traceback.format_exc())
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"gpubench: the run loaded {bad}, which it may not")
        return 4
    for c in checks:
        log(c)
    print(json.dumps(line), flush=True)
    return 0
