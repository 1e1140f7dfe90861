"""Port: text -> wav end to end against the JAX chain, the weight bridge,
the CLI, import hygiene and the CUDA guard, on the CPU.

Tolerance for the waveform: 2e-3, the JAX package's bound for its kernel
against its scan (tests/test_polyphase.py:147-175); the Tacotron half must
stop at the same group on both sides.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import TacotronConfig as JTTS
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops.fold import num_folds_for
from wavernn_tpu.text import text_to_sequence as j_text_to_sequence
from wavernn_tpu.train.checkpoints import save_tree, tree_to_flat
from wavernn_tpu_torch.cli import quick_start
from wavernn_tpu_torch.cli.common import load_tts_model, load_voc_model
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, TacotronConfig, WaveRNNConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.synthesis import tts_to_wav
from wavernn_tpu_torch.text import text_to_sequence

ROOT = Path(__file__).resolve().parents[1]
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1)
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)
TARGET, OVERLAP = 4 * 275, 275
TEXT = "The birch canoe slid on the smooth planks."


def _jax_params():
    voc = jwr.init_wavernn(jax.random.PRNGKey(4), JVoc(**VOC), JDSP())
    tts = jtaco.init_tacotron(jax.random.PRNGKey(5), JTTS(**TTS), 80)
    return voc, tts


def _cfg():
    return Config(voc=WaveRNNConfig(**VOC), tts=TacotronConfig(**TTS))


def _port_models(voc_p, tts_p, cfg):
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.load_state_dict(state_dict_from_jax(tree_to_flat(voc_p), cfg),
                        strict=True)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.load_state_dict(state_dict_from_jax(tree_to_flat(tts_p), cfg),
                        strict=True)
    return voc, tts


def test_tts_to_wav_matches_jax_chain():
    voc_p, tts_p = _jax_params()
    cfg = _cfg()
    voc, tts = _port_models(voc_p, tts_p, cfg)
    r, steps = 2, 24   # 24 frames: the wave outlasts the 20-frame fade
    ids = np.asarray(j_text_to_sequence(TEXT, ("english_cleaners",)))
    assert list(ids) == text_to_sequence(TEXT, cfg.tts.cleaner_names)
    _, m, _ = jtaco.generate(tts_p, ids, JTTS(**TTS), r, 80, steps=steps,
                             impl="scan")
    m = np.clip((m + 4.0) / 8.0, 0.0, 1.0)
    B = num_folds_for(m.shape[1] * 275, TARGET, OVERLAP)
    rng = np.random.RandomState(7)
    T = TARGET + 2 * OVERLAP
    noise = (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
             rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))
    want = np.asarray(jwr.generate_fast(
        voc_p, m[None], JVoc(**VOC), JDSP(), jax.random.PRNGKey(0),
        target=TARGET, overlap=OVERLAP, use_pallas=True, interpret=True,
        noise=tuple(map(jnp.asarray, noise)), compute_dtype=jnp.float32))

    wav, m_t, attn = tts_to_wav(tts, voc, TEXT, cfg, r, steps=steps,
                                noise=tuple(map(torch.from_numpy, noise)),
                                target=TARGET, overlap=OVERLAP, device="cpu")
    assert m_t.shape == m.shape
    np.testing.assert_allclose(m_t, m, atol=2e-3)
    assert wav.dtype == np.float64 and wav.shape == want.shape
    # samples lie in [-1, 1]; where two folds cross-fade, the equal-power
    # ramps sum to at most sqrt(2)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= np.sqrt(2) + 1e-9
    np.testing.assert_allclose(wav, want, atol=2e-3)


def test_bridge_round_trip_is_strict():
    voc_p, tts_p = _jax_params()
    cfg = _cfg()
    voc, tts = _port_models(voc_p, tts_p, cfg)
    np.testing.assert_array_equal(voc.I.weight.detach().numpy(),
                                  np.asarray(voc_p["I"]["w"]).T)
    np.testing.assert_array_equal(
        voc.upsample.up_layers[3].weight.detach().numpy(),
        np.asarray(voc_p["upsample"]["up_convs"][1]["w"]))
    np.testing.assert_array_equal(
        tts.postnet.rnn.weight_hh_l0_reverse.detach().numpy(),
        np.asarray(tts_p["postnet"]["rnn_bwd"]["wh"]).T)
    flat = tree_to_flat(voc_p)
    with pytest.raises(KeyError, match="not mapped"):
        state_dict_from_jax({**flat, "extra/w": np.zeros(1)}, cfg)
    flat.pop("fc3/b")
    with pytest.raises(KeyError, match="fc3/b"):
        state_dict_from_jax(flat, cfg)


def test_cli_loads_both_formats_and_synthesizes(tmp_path):
    voc_p, tts_p = _jax_params()
    cfg = _cfg()
    voc, tts = _port_models(voc_p, tts_p, cfg)
    save_tree(tmp_path / "voc.npz", {"params": voc_p,
                                     "meta": {"step": np.asarray(3000)}})
    save_tree(tmp_path / "tts.npz", {"params": tts_p,
                                     "meta": {"step": np.asarray(5000),
                                              "r": np.asarray(2)}})
    v, v_step = load_voc_model(tmp_path / "voc.npz", cfg, "cpu")
    t, t_step, r = load_tts_model(tmp_path / "tts.npz", cfg, "cpu")
    assert (v_step, t_step, r) == (3000, 5000, 2)
    for a, b in zip(v.parameters(), voc.parameters()):
        assert torch.equal(a, b)
    torch.save(t.state_dict(), tmp_path / "tts.pyt")
    t2, t2_step, r2 = load_tts_model(tmp_path / "tts.pyt", cfg, "cpu")
    assert (t2_step, r2) == (5000, 2)
    for a, b in zip(t.state_dict().values(), t2.state_dict().values()):
        assert torch.equal(a, b)

    hp = tmp_path / "hparams_small.py"
    hp.write_text("".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
                  + "".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items())
                  + f"voc_target = {TARGET}\nvoc_overlap = {OVERLAP}\n")
    out = tmp_path / "out"
    quick_start.main(["--hp_file", str(hp), "--voc_weights",
                      str(tmp_path / "voc.npz"), "--tts_weights",
                      str(tmp_path / "tts.npz"), "--input_text", "Hi.",
                      "--steps", "16", "--out_dir", str(out), "--force_cpu"])
    assert [p.name for p in out.iterdir()] == ["1_batchedTrue_5k.wav"]


def test_quick_start_batched_flags_match_jax(tmp_path, capsys):
    """quick_start's -b / -u / -a, as the JAX package's CLI has them: -u
    generates unbatched and names the file batchedFalse; -a writes the
    attention png beside the wav; --out_dir and --steps say that they are
    the port's own."""
    from wavernn_tpu.cli import quick_start as j_quick_start
    with pytest.raises(SystemExit):
        j_quick_start.main(["--help"])
    jhelp = capsys.readouterr().out
    with pytest.raises(SystemExit):
        quick_start.main(["--help"])
    phelp = capsys.readouterr().out
    for flag in ("--batched", "-b", "--unbatched", "-u", "--save_attention",
                 "-a", "--input_text", "--voc_weights", "--tts_weights",
                 "--pretrained_dir", "--hp_file", "--force_cpu"):
        assert flag in jhelp and flag in phelp, flag
    assert "--out_dir" not in jhelp and "--steps" not in jhelp
    assert phelp.count("the port's own") == 2
    voc_p, tts_p = _jax_params()
    save_tree(tmp_path / "voc.npz", {"params": voc_p,
                                     "meta": {"step": np.asarray(3000)}})
    save_tree(tmp_path / "tts.npz", {"params": tts_p,
                                     "meta": {"step": np.asarray(5000),
                                              "r": np.asarray(2)}})
    hp = tmp_path / "hparams_small.py"
    hp.write_text("".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
                  + "".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items()))
    args = ["--hp_file", str(hp), "--voc_weights", str(tmp_path / "voc.npz"),
            "--tts_weights", str(tmp_path / "tts.npz"), "--input_text",
            "Hi.", "--steps", "16", "--force_cpu"]
    out = tmp_path / "out"
    quick_start.main(args + ["-u", "--out_dir", str(out)])
    assert [p.name for p in out.iterdir()] == ["1_batchedFalse_5k.wav"]
    quick_start.main(args + ["-u", "-a", "--out_dir", str(out)])
    assert sorted(p.name for p in out.iterdir()) == [
        "1_batchedFalse_5k.wav", "1_batchedFalse_5k.wav.png"]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import wavernn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'wavernn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'wavernn_tpu.'))\n"
        "             or n == 'wavernn_tpu')\n"
        "assert 'wavernn_tpu_torch.cli.quick_start' in sys.modules\n"
        "assert 'wavernn_tpu_torch.models.deepmind' in sys.modules\n"
        "assert 'wavernn_tpu_torch.utils.backend' in sys.modules\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = _cfg()
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    tts = taco.Tacotron(cfg.tts, 80)
    with pytest.raises(RuntimeError, match="CUDA"):
        tts_to_wav(tts, voc, TEXT, cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        wr.generate(voc, np.zeros((1, 80, 5), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        taco.generate(tts, [1, 2, 3], 2)
