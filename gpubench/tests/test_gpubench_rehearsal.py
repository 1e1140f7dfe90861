"""Each cell rehearsed on the CPU at a cut size: the whole run (set-up,
window, metrics, the check against the plain reference) in a fresh
interpreter, with and without the trace; and the check coming out false
when the timed path is broken underneath."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gpubench import harness
from gpubench.tests import tiny

CELLS = [w["name"] for w in harness.load_manifest(harness.ROOT)["workloads"]]

SCRIPT = """
import json, sys
from gpubench import harness
from gpubench.tests import tiny
line, checks = tiny.run(sys.argv[1], trace=sys.argv[2] == "1")
print(json.dumps({"line": line, "forbidden": harness.forbidden_modules()}))
"""


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT, cell, trace],
                         cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    line = got["line"]
    assert got["forbidden"] == []
    assert line["correct"], line
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    spec = tiny.spec(cell)
    want = ({m["name"] for m in spec["end_to_end"]} if trace == "0"
            else set())
    assert want <= set(line["metrics"])
    for m in line["metrics"].values():
        assert np.isfinite(m["value"])


def _alter_served_samples(entry):
    call = entry.Runner._call

    def altered(self, c, gen, timings):
        outs = call(self, c, gen, timings)
        for wave, _ in outs:
            # a run of samples wider than any stretch the check skips
            wave[len(wave) // 2:len(wave) // 2 + 300] += 0.25
        return outs
    entry.Runner._call = altered


def _freeze_state(entry):
    entry.Runner._step = lambda self, b, timings: {
        "loss": b["mel"].new_zeros(())}


def _half_batch(entry):
    step = entry.Runner._step

    def half(self, b, timings):
        h = b["ids"].shape[0] // 2
        cut = {"ids": b["ids"][:h], "mel": b["mel"][:h],
               "aref": b["aref"][:h],
               "masks": {k: (v[:h] if k.startswith("enc") else v[:, :h])
                         .contiguous() for k, v in b["masks"].items()}}
        return step(self, cut, timings)
    entry.Runner._step = half


@pytest.mark.parametrize("cell,fault", [
    ("tts_batch.lj_mol", _alter_served_samples),
    ("tts_single.lj_mol", _alter_served_samples),
    ("train_af.lj_af_offline", _freeze_state),
    ("train_af.lj_af_offline", _half_batch)])
def test_a_broken_path_is_not_correct(cell, fault):
    import importlib
    entry = importlib.import_module(
        f"gpubench.entries.{tiny.spec(cell)['mix']['entry']}")
    saved = dict(vars(entry.Runner))
    try:
        line, _ = tiny.run(cell, entry_patch=fault)
    finally:
        for k in ("_call", "_step"):
            if k in saved:
                setattr(entry.Runner, k, saved[k])
    assert line["correct"] is False
