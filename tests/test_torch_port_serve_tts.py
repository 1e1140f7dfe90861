"""Port parity, serving text -> wav: the length-aware encoder, the batched
decode's plain version (B8's), ``generate_batch``, ``tts_to_wav_batch`` /
``tts_to_wav_fast`` and the ``gen_tacotron`` CLI, against the JAX package
on the CPU.

Weights: JAX ``init_tacotron`` / ``init_wavernn`` -> the port's weight
bridge; noise: the same numpy uniforms on both sides; the JAX sample-loop
kernel in interpret mode with float32 compute, as its own tests run it.

Tolerances: 2e-5 for the encoder and the decode (float32, summation order
only, over at most 20 dependent groups); the same stop group on both
sides; 2e-3 for waves (the JAX package's kernel-against-scan bound,
tests/test_polyphase.py:147-175).
"""
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget
from scipy.io import wavfile

from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import TacotronConfig as JTTS
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops import pallas_gen as jpg
from wavernn_tpu.ops.fold import num_folds_for
from wavernn_tpu.text import text_to_sequence as j_text_to_sequence
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.cli import gen_tacotron
from wavernn_tpu_torch.cli.common import make_workspace
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, TacotronConfig, WaveRNNConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.synthesis import tts_to_wav_batch, tts_to_wav_fast
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.train.checkpoints import save_checkpoint
from wavernn_tpu_torch.train.wavernn_train import make_optimizer

VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1)
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)
TARGET, OVERLAP, HOP = 4 * 275, 275, 275
TEXTS = ["The birch canoe slid on the smooth planks.",
         "Glue the sheet.",
         "It's easy to tell the depth of a well, they say."]
R, STEPS = 2, 40
BUCKETS = (16, 32)


def _ids(text):
    return np.asarray(j_text_to_sequence(text, ("english_cleaners",)))


def _padded(texts):
    seqs = [_ids(t) for t in texts]
    T = max(len(s) for s in seqs)
    return (np.stack([np.pad(s, (0, T - len(s))) for s in seqs]),
            np.asarray([len(s) for s in seqs]))


@pytest.fixture(scope="module")
def nets():
    """JAX parameters, the port's models on the same weights, and a stop
    threshold at which the three sentences stop at different groups."""
    tts_p = jtaco.init_tacotron(jax.random.PRNGKey(5), JTTS(**TTS), 80)
    voc_p = jwr.init_wavernn(jax.random.PRNGKey(4), JVoc(**VOC), JDSP())
    x, lens = _padded(TEXTS)
    mel, _, _, nv = jtaco._generate_scan(
        tts_p, jnp.asarray(x), JTTS(**TTS), R, STEPS, 80,
        jax.random.PRNGKey(0), text_lens=jnp.asarray(lens))
    assert list(np.asarray(nv)) == [STEPS // R] * 3   # random weights
    thr = _stop_threshold(np.asarray(mel))
    cfg = Config(voc=WaveRNNConfig(**VOC),
                 tts=TacotronConfig(stop_threshold=thr, **TTS))
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.load_state_dict(state_dict_from_jax(tree_to_flat(voc_p), cfg),
                        strict=True)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.load_state_dict(state_dict_from_jax(tree_to_flat(tts_p), cfg),
                        strict=True)
    return dict(tts_p=tts_p, voc_p=voc_p, cfg=cfg, thr=thr,
                jtts=JTTS(stop_threshold=thr, **TTS), tts=tts.eval(),
                voc=voc.eval(), no_stop_mel=np.asarray(mel))


def _stop_threshold(mel):
    """From a decode that never stopped, the threshold with the most
    distinct stop groups among the rows, the widest margin breaking ties:
    row b stops at the first group g with g*r > 10 whose largest value is
    below it."""
    B, _, steps = mel.shape
    G = steps // R
    peaks = mel.reshape(B, 80, G, R).max(axis=(1, 3))     # (B, G)
    live = peaks[:, [g for g in range(G) if g * R > 10]]
    vals = np.unique(live)
    best = None
    for lo, hi in zip(vals[:-1], vals[1:]):
        thr = float((lo + hi) / 2)
        stops = [next((g + 1 for g in range(G)
                       if g * R > 10 and peaks[b, g] < thr), G)
                 for b in range(B)]
        score = (len(set(stops)), hi - lo)
        if best is None or score > best[0]:
            best = (score, thr)
    return best[1]


def test_encoder_with_lens_matches_jax(nets):
    x, lens = _padded(TEXTS)
    want, _ = jtaco.encoder_apply(nets["tts_p"]["encoder"], jnp.asarray(x),
                                  jax.random.PRNGKey(0), False, 0.5,
                                  lens=jnp.asarray(lens))
    with torch.no_grad():
        got = nets["tts"].encoder(torch.from_numpy(x),
                                  lens=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], atol=2e-5)
    # each padded row encodes as it would alone
    with torch.no_grad():
        solo = nets["tts"].encoder(torch.from_numpy(x[1:2, :lens[1]]))
    np.testing.assert_allclose(got[1, :lens[1]].numpy(), solo[0].numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("stop", [False, True])
def test_batched_decode_matches_jax_generate_scan(nets, stop):
    """B8's plain version through ``generate_core`` (length-aware encoder,
    masked decode, postnet) against ``_generate_scan(text_lens=)``, with no
    stop and with the rows stopping at different groups."""
    x, lens = _padded(TEXTS)
    tts = nets["tts"]
    if stop:
        jtts = nets["jtts"]
        mel, lin, att, nv = jtaco._generate_scan(
            nets["tts_p"], jnp.asarray(x), jtts, R, STEPS, 80,
            jax.random.PRNGKey(0), text_lens=jnp.asarray(lens))
        nv = np.asarray(nv)
        assert len(set(nv)) >= 2
    else:
        tts = taco.Tacotron(TacotronConfig(**TTS), 80)
        tts.load_state_dict(nets["tts"].state_dict())
        mel, nv = nets["no_stop_mel"], [STEPS // R] * 3
    got = taco.generate_core(tts.eval(), torch.from_numpy(x),
                             torch.from_numpy(lens), R, STEPS)
    assert got[3].tolist() == list(nv)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(mel), atol=2e-5)
    if stop:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(lin),
                                   atol=2e-5)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[2][b, :, :n].numpy(),
                                       np.asarray(att)[b, :, :n], atol=2e-5)
        # a stopped row repeats its frozen group
        g = int(nv.min())
        b = int(nv.argmin())
        np.testing.assert_array_equal(got[0][b, :, g * R:(g + 1) * R],
                                      got[0][b, :, -R:])


def test_generate_batch_matches_jax(nets):
    seqs = [_ids(t) for t in TEXTS]
    want = jtaco.generate_batch(nets["tts_p"], seqs, nets["jtts"], R, 80,
                                steps=STEPS, impl="scan")
    got = taco.generate_batch(nets["tts"], seqs, R, steps=STEPS,
                              device="cpu")
    for (gm, gl, ga), (wm, wl, wa) in zip(got, want):
        assert gm.shape == wm.shape and ga.shape == wa.shape
        np.testing.assert_allclose(gm, wm, atol=2e-5)
        np.testing.assert_allclose(gl, wl, atol=2e-5)
        np.testing.assert_allclose(ga, wa, atol=2e-5)


def _bucket(T_valid, steps=STEPS):
    return min(next((b for b in BUCKETS if b >= T_valid), steps), steps)


def _host_fade(w, T_valid):
    wave_valid = max(T_valid - 1, 1) * HOP
    w = np.array(np.asarray(w)[:wave_valid], dtype=np.float32)
    n = min(20 * HOP, wave_valid)
    w[-n:] *= np.linspace(1.0, 0.0, n, dtype=w.dtype)
    return w


def _f32_kernel(monkeypatch):
    """The JAX serving programs call the sample-loop kernel in bfloat16:
    hold it to float32, as its tests do, with a compile cache of its own."""
    fused = jpg.generate_pallas_fused
    monkeypatch.setattr(jpg, "generate_pallas_fused",
                        lambda *a, **k: fused(*a, **{
                            **k, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(jwr, "_MULTI_PROG_CACHE", {})


def _noise(B, seed):
    rng = np.random.RandomState(seed)
    T = TARGET + 2 * OVERLAP
    return (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
            rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))


def test_tts_to_wav_batch_matches_jax_chain(nets, monkeypatch):
    """The JAX package's tts_to_wav_batch takes no injected noise, so its
    chain is composed here (wavernn_tpu/synthesis.py:214-253)."""
    _f32_kernel(monkeypatch)
    x, lens = _padded(TEXTS)
    _, lin, _, nv = jtaco._generate_scan(
        nets["tts_p"], jnp.asarray(x), nets["jtts"], R, STEPS, 80,
        jax.random.PRNGKey(0), text_lens=jnp.asarray(lens))
    t_valid = [min(int(n) * R, STEPS) for n in np.asarray(nv)]
    mels = [jnp.clip((lin[b, :, :_bucket(t)] + 4.0) / 8.0, 0.0, 1.0)
            for b, t in enumerate(t_valid)]
    B = sum(num_folds_for(m.shape[-1] * HOP, TARGET, OVERLAP) for m in mels)
    noise = _noise(B, 8)
    wavs = jwr.generate_multi(nets["voc_p"], mels, JVoc(**VOC), JDSP(),
                              jax.random.PRNGKey(0), target=TARGET,
                              overlap=OVERLAP, use_pallas=True,
                              interpret=True,
                              noise=tuple(map(jnp.asarray, noise)),
                              device_out=True, tail_fade=False)
    got = tts_to_wav_batch(nets["tts"], nets["voc"], TEXTS, nets["cfg"], R,
                           steps=STEPS, mel_buckets=BUCKETS,
                           noise=tuple(map(torch.from_numpy, noise)),
                           target=TARGET, overlap=OVERLAP, device="cpu")
    for (wav, mel), w, t, m in zip(got, wavs, t_valid, mels):
        assert mel.shape == (80, t)
        np.testing.assert_allclose(mel, np.asarray(m)[:, :t], atol=2e-5)
        want = _host_fade(w, t)
        assert wav.dtype == np.float32 and wav.shape == want.shape
        np.testing.assert_allclose(wav, want, atol=2e-3)


def test_tts_to_wav_fast_matches_jax_chain(nets):
    """One sentence (wavernn_tpu/synthesis.py:279-311): B2's path, the
    bucket, generate_fast without the tail fade, the host fade."""
    ids = _ids(TEXTS[0])[None]
    _, lin, _, nv = jtaco._generate_scan(
        nets["tts_p"], jnp.asarray(ids), nets["jtts"], R, STEPS, 80,
        jax.random.PRNGKey(0))
    t = min(int(nv[0]) * R, STEPS)
    mel01 = jnp.clip((lin[:, :, :_bucket(t)] + 4.0) / 8.0, 0.0, 1.0)
    noise = _noise(num_folds_for(mel01.shape[-1] * HOP, TARGET, OVERLAP), 9)
    w = jwr.generate_fast(nets["voc_p"], mel01, JVoc(**VOC), JDSP(),
                          jax.random.PRNGKey(0), target=TARGET,
                          overlap=OVERLAP, use_pallas=True, interpret=True,
                          compute_dtype=jnp.float32,
                          noise=tuple(map(jnp.asarray, noise)),
                          tail_fade=False)
    wav, mel = tts_to_wav_fast(nets["tts"], nets["voc"], TEXTS[0],
                               nets["cfg"], R, steps=STEPS,
                               mel_buckets=BUCKETS,
                               noise=tuple(map(torch.from_numpy, noise)),
                               target=TARGET, overlap=OVERLAP, device="cpu")
    assert mel.shape == (80, t)
    want = _host_fade(w, t)
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=2e-3)


def test_cli_synthesizes_from_port_checkpoints(nets, tmp_path, monkeypatch):
    """``gen_tacotron --force_cpu wavernn`` with --batch_sentences, --fast
    and --unbatched on a two-line sentence file, from checkpoints the port
    wrote; the stop threshold is set high so each decode stops at its
    first eligible group. The CLI's 2000-frame decode bound is cut to
    STEPS: the plain postnet runs over the whole bound."""
    monkeypatch.chdir(tmp_path)
    for name in ("tts_to_wav", "tts_to_wav_fast", "tts_to_wav_batch"):
        monkeypatch.setattr(gen_tacotron, name, functools.partial(
            getattr(gen_tacotron, name), steps=STEPS))
    (tmp_path / "two.txt").write_text(f"{TEXTS[1]}\n{TEXTS[0]}\n")
    hp = tmp_path / "hp.py"
    hp.write_text("".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
                  + "".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items())
                  + f"voc_target = {TARGET}\nvoc_overlap = {OVERLAP}\n"
                  + "tts_stop_threshold = 10.0\n"
                  + "test_sentences_file = 'two.txt'\n")
    cfg = Config.from_hparams_file(hp)
    ws = make_workspace(cfg)
    save_checkpoint("tts", ws, nets["tts"], make_optimizer(nets["tts"], 1e-3),
                    3000, r=R, log=lambda *_: None)
    save_checkpoint("voc", ws, nets["voc"], make_optimizer(nets["voc"], 1e-3),
                    7000, log=lambda *_: None)
    for flags, names in (
            (["--batch_sentences"], ["1_wavernn_batchN_3k.wav",
                                     "2_wavernn_batchN_3k.wav"]),
            (["--fast"], ["1_wavernn_fast_3k.wav", "2_wavernn_fast_3k.wav"]),
            (["--unbatched"], ["1_wavernn_unbatched_3k.wav",
                               "2_wavernn_unbatched_3k.wav"])):
        gen_tacotron.main(["--hp_file", str(hp), "--force_cpu", "wavernn",
                           *flags])
        for name in names:
            sr, pcm = wavfile.read(ws.tts_output / name)
            assert sr == 22050 and pcm.dtype == np.int16 and pcm.size > 0
            assert np.abs(pcm.astype(np.float64)).max() < 2 ** 15
    # griffinlim reads no vocoder checkpoint; -a writes each sentence's
    # attention beside its wav, on the per-sentence wavernn path too
    voc_loader = gen_tacotron.load_voc_model

    def no_vocoder(*a, **k):
        raise AssertionError("griffinlim loaded a vocoder checkpoint")
    monkeypatch.setattr(gen_tacotron, "load_voc_model", no_vocoder)
    gen_tacotron.main(["--hp_file", str(hp), "--force_cpu", "-a",
                       "griffinlim", "--iters", "2"])
    monkeypatch.setattr(gen_tacotron, "load_voc_model", voc_loader)
    for i in (1, 2):
        sr, pcm = wavfile.read(ws.tts_output / f"{i}_griffinlim_3k.wav")
        assert sr == 22050 and pcm.dtype == np.int16 and pcm.size > 0
        assert (ws.tts_output / f"{i}_griffinlim_3k.wav.png").is_file()
    gen_tacotron.main(["--hp_file", str(hp), "--force_cpu",
                       "--save_attention", "wavernn", "--unbatched"])
    for i in (1, 2):
        png = ws.tts_output / f"{i}_wavernn_unbatched_3k.wav.png"
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert Path(ws.tts_output).is_dir()
    assert text_to_sequence(TEXTS[0], cfg.tts.cleaner_names) \
        == list(_ids(TEXTS[0]))
