"""A later change adds a cell, its traffic and a per-layer metric by
adding files and BENCHMARK.json entries alone: shown in a copy of the
benchmark, where no file that was there changes."""
import json
import shutil

from gpubench import harness
from gpubench.tests import tiny


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = harness.load_manifest(harness.ROOT)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    g = root / "gpubench"
    mix = json.loads((g / "workloads" / "tts_batch.json").read_text())
    mix["batch"] = 4
    (g / "workloads" / "tts_batch4.json").write_text(json.dumps(mix))
    (g / "limits" / "tts_batch4.lj_mol.json").write_text(
        (g / "limits" / "tts_batch.lj_mol.json").read_text())
    (g / "metrics" / "calls_done.batch4.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    bench["workloads"].append(
        {"name": "tts_batch4.lj_mol", "config": "lj_mol",
         "traffic": "tts_batch4", "chips": 1,
         "why": "4-sentence batches: a throwaway cell of this test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("tts_batch4.lj_mol")
    bench["per_layer"].append(
        {"name": "calls_done.batch4", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "entry",
         "moves": "audio_s_per_s", "workloads": ["tts_batch4.lj_mol"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = tiny.spec("tts_batch4.lj_mol", root)
    assert spec["mix"]["batch"] == 4
    line, _ = tiny.run("tts_batch4.lj_mol", trace=True, root=root)
    assert line["correct"]
    assert line["metrics"]["calls_done.batch4"]["value"] >= 1
    line, _ = tiny.run("tts_batch4.lj_mol", root=root)
    assert "audio_s_per_s" in line["metrics"]
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []
