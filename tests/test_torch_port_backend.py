"""The port's backend rule (``wavernn_tpu_torch/utils/backend.py``), the
PyTorch examples (``examples/torch_*.py``) run in-process on the CPU for a
couple of steps, and the experiment launcher
(``scripts/run_taco_wrnn_torch.sh``). No JAX: the examples and the rule
import only the port, numpy and scipy."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu_torch.utils import backend

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_deepmind_fit", "torch_nb1_sine_fit",
            "torch_nb2_short_sample_fit", "torch_nb3_long_sample_fit",
            "torch_nb4_conditioned_fit")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("value,want", [("auto", "pallas"), ("scan", "scan"),
                                        ("pallas", "pallas")])
def test_resolve_recurrence(value, want):
    # the wrappers decide by their tensors' device, so "auto" resolves the
    # same way with or without a mesh
    assert backend.resolve_recurrence(value) == want
    assert backend.resolve_recurrence(value, mesh=object()) == want


def test_backend_rule_on_the_cpu_and_unknown_values():
    with pytest.raises(ValueError, match="recurrence"):
        backend.resolve_recurrence("xla")
    # "auto" on CPU tensors: the kernels' wrappers, which run the plain
    # versions there (the B5 wrapper's own count stays unchanged)
    from wavernn_tpu_torch.ops import cuda_gru, layers
    n = cuda_gru.gru_seq_tm.fwd_launches
    xs = torch.randn(2, 5, 8)
    w = (torch.randn(24, 8), torch.randn(24, 8), torch.zeros(24),
         torch.zeros(24))
    engine = "scan" if backend.resolve_recurrence("auto") == "scan" \
        else "kernel"
    ys, _ = layers.gru(xs, *w, engine=engine)
    want, _ = layers.gru(xs, *w, engine="scan")
    assert cuda_gru.gru_seq_tm.fwd_launches == n
    assert torch.allclose(ys, want, atol=1e-6)


def test_trainers_resolve_through_the_backend():
    from wavernn_tpu_torch.train import tacotron_train, wavernn_train
    assert tacotron_train.resolve_recurrence is backend.resolve_recurrence
    assert wavernn_train.resolve_recurrence is backend.resolve_recurrence


@pytest.mark.parametrize("name,argv", [
    ("torch_nb1_sine_fit", ["--steps", "2", "--hidden", "32", "--seq_len",
                            "24", "--batch", "2", "--gen_len", "12"]),
    ("torch_nb2_short_sample_fit", ["--steps", "2", "--hidden", "32",
                                    "--seq_len", "24", "--batch", "2",
                                    "--gen_len", "12"]),
    ("torch_nb3_long_sample_fit", ["--steps", "2", "--hidden", "32",
                                   "--seq_len", "24", "--batch", "2",
                                   "--minutes", "0.01",
                                   "--gen_seconds", "0.0005"]),
])
def test_deepmind_examples_run_on_cpu(tmp_path, name, argv, capsys):
    wav = _example(name).main(argv + ["--device", "cpu",
                                      "--out", str(tmp_path)])
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert list(tmp_path.glob("*.wav"))
    assert "step 2/2 loss" in capsys.readouterr().out


def test_deepmind_example_reads_a_wav(tmp_path):
    from scipy.io import wavfile
    t = np.arange(2000) / 8000
    wavfile.write(tmp_path / "in.wav", 8000,
                  (np.sin(2 * np.pi * 300 * t) * 2 ** 14).astype(np.int16))
    wav = _example("torch_nb2_short_sample_fit").main(
        ["--wav", str(tmp_path / "in.wav"), "--steps", "1", "--hidden", "32",
         "--seq_len", "24", "--batch", "2", "--gen_len", "8", "--device",
         "cpu", "--out", str(tmp_path / "out")])
    assert wav.shape == (8,)


def test_conditioned_example_runs_on_cpu(tmp_path, capsys):
    wav = _example("torch_nb4_conditioned_fit").main(
        ["--steps", "2", "--batch", "2", "--seconds", "1",
         "--gen_frames", "6", "--rnn_dims", "32", "--fc_dims", "32",
         "--device", "cpu", "--out", str(tmp_path)])
    assert np.isfinite(wav).all() and wav.size > 0
    assert (tmp_path / "copy_synthesis.wav").exists()
    assert "step 2/2 loss" in capsys.readouterr().out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("torch_nb1_sine_fit").main(["--steps", "1", "--hidden",
                                             "32"])


def test_examples_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib.util\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        f"for n in {EXAMPLES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(n, "
        f"{str(ROOT / 'examples')!r} + '/' + n + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import wavernn_tpu_torch.models.deepmind, "
        "wavernn_tpu_torch.utils.backend\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'wavernn_tpu')\n"
        "             or n.startswith(('jax.', 'wavernn_tpu.')))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_launcher_syntax_and_menu():
    script = ROOT / "scripts" / "run_taco_wrnn_torch.sh"
    assert subprocess.run(["bash", "-n", str(script)],
                          timeout=60).returncode == 0
    text = script.read_text()
    for exp in ("preprocess", "taco_tf", "taco_gta", "taco_attn",
                "taco_af_online", "taco_af_offline", "wrnn", "wrnn_gta",
                "gen", "quick_start"):
        assert f"  {exp})" in text
    assert "wavernn_tpu_torch.cli" in text and "wavernn_tpu.cli" not in text
    out = subprocess.run(["bash", str(script), "nonsense"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1 and "unknown experiment" in out.stderr
