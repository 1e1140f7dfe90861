"""A later change adds a cell, its traffic, its entry module (with its
own CPU cut and program counters) and a per-layer metric by adding files
and BENCHMARK.json entries alone: shown in a copy of the benchmark, where
no file that was there changes."""
import json
import shutil

import pytest

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


# a new entry module: the tts entry with a counter of its own and a check
# number of its own, its CPU cut brought in the module
COUNTED_ENTRY = '''
from .tts import Runner as Tts

TINY_MIX = {"batch": 2, "lengths": [6, 9], "judge_calls": 1}
TINY_CFG = {"voc_rnn_dims": 48, "voc_fc_dims": 48}
TINY_LIMITS = {"unserved": 0}


class Runner(Tts):
    served = 0

    def _call(self, c, gen, timings):
        self.served += 1
        return super()._call(c, gen, timings)

    def counters(self):
        return {"served": self.served}

    def judge(self, res):
        done = sum(r["outs"] is not None for r in res["recs"])
        return {**super().judge(res), "unserved": len(res["recs"]) - done}
'''


def test_a_cell_with_its_own_entry_cut_and_counter_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = harness.load_manifest(harness.ROOT)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    g = root / "gpubench"
    (g / "entries" / "tts_counted.py").write_text(COUNTED_ENTRY)
    mix = json.loads((g / "workloads" / "tts_batch.json").read_text())
    mix["entry"] = "tts_counted"
    (g / "workloads" / "tts_counted.json").write_text(json.dumps(mix))
    (g / "limits" / "tts_counted.lj_mol.json").write_text(json.dumps(
        {"mel_gap": 1e-6, "sample_gap": 1e-4, "unserved": 0}))
    (g / "metrics" / "served.counted.py").write_text(
        "def read(ctx):\n    n = ctx.counters.get('served')\n"
        "    return None if n is None else float(n)\n")
    bench["workloads"].append(
        {"name": "tts_counted.lj_mol", "config": "lj_mol",
         "traffic": "tts_counted", "chips": 1,
         "why": "a counted tts entry: a throwaway cell of this test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("tts_counted.lj_mol")
    bench["per_layer"].append(
        {"name": "served.counted", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "entry",
         "moves": "audio_s_per_s", "workloads": ["tts_counted.lj_mol"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = tiny.spec("tts_counted.lj_mol", root)
    assert spec["cfg"]["voc_rnn_dims"] == 48
    assert spec["cfg"]["tts_lstm_dims"] == tiny.TINY_CFG["tts_lstm_dims"]
    assert spec["mix"]["lengths"] == [6, 9]
    assert spec["limits"] == {"mel_gap": tiny.TINY_LIMITS["mel_gap"],
                              "sample_gap": tiny.TINY_LIMITS["sample_gap"],
                              "unserved": 0}
    line, checks = tiny.run("tts_counted.lj_mol", trace=True, root=root)
    assert line["correct"], checks
    assert line["checks"]["unserved"]["value"] == 0
    # the window's calls, counted by the program: set-up's pass left out
    assert line["metrics"]["served.counted"]["value"] == line["attempted"]
    line, _ = tiny.run("tts_counted.lj_mol", root=root)
    assert line["correct"] and "audio_s_per_s" in line["metrics"]
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []


# the cut of the cells that bring none of their own, as the shared tables
# made it before entries could bring theirs: widths changed from the
# configuration, the whole mix, the limits
CUT_WIDTHS = {"tts_embed_dims": 32, "tts_encoder_K": 3, "tts_lstm_dims": 32,
              "tts_num_highways": 1, "tts_postnet_K": 3,
              "tts_postnet_dims": 16, "voc_compute_dims": 16,
              "voc_fc_dims": 32, "voc_overlap": 275, "voc_res_blocks": 2,
              "voc_res_out_dims": 16, "voc_rnn_dims": 32, "voc_target": 550}
SERVE_LIMITS = {"mel_gap": 0.0001, "sample_gap": 0.002}
FROZEN_CUTS = {
    "tts_batch.lj_mol": (
        {"entry": "tts", "batch": 2, "lengths": [6, 9, 12, 15],
         "frames_per_char": 5.3, "judge_calls": 2, "judge_margin": 32},
        SERVE_LIMITS),
    "tts_single.lj_mol": (
        {"entry": "tts", "batch": 1, "lengths": [6, 9, 12, 15],
         "frames_per_char": 5.3, "judge_calls": 2, "judge_margin": 32},
        SERVE_LIMITS),
    "train_af.lj_af_offline": (
        {"entry": "train_af", "max_frames": [20, 30, 40, 50],
         "spread": [1.0, 0.8], "frames_per_char": 5.3, "num_mels": 80,
         "attn_width": 1.5},
        {"loss_gap": 0.0001, "grad_gap": 0.001, "change_gap": 0.02}),
}


@pytest.mark.parametrize("cell", sorted(FROZEN_CUTS))
def test_the_shared_tables_cut_as_before(cell):
    spec = tiny.spec(cell)
    full = harness.cell_spec(harness.load_manifest(harness.ROOT), cell)
    mix, limits = FROZEN_CUTS[cell]
    assert {k: v for k, v in spec["cfg"].items()
            if full["cfg"].get(k) != v} == CUT_WIDTHS
    assert set(spec["cfg"]) == set(full["cfg"]) | set(CUT_WIDTHS)
    assert spec["mix"] == mix and list(spec["mix"]) == list(mix)
    assert spec["limits"] == limits
