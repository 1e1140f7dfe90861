"""Port: dataset preprocessing (data/preprocess.py, cli/preprocess.py), the
``.wav`` input of the vocoder, Griffin-Lim text -> wav and the PNG savers,
against the JAX package on the CPU.

A tiny corpus: six sine and chirp wavs of 0.3-0.6 s and a metadata.csv.
The preprocessed artifacts must be the JAX package's bytes. Griffin-Lim text
-> wav is held stage by stage: the mel within 2e-3 (the port's Tacotron
bound); from the JAX mel the NNLS and the whole inversion, each with its
bound at its assert (the whole within 5e-3, tests/test_torch_port_dsp.py's
reconstruct_waveform bound).
"""
import pickle
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu import dsp as J
from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.config import TacotronConfig as JTTS
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.data.preprocess import preprocess as j_preprocess
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.paths import Workspace as JWorkspace
from wavernn_tpu.synthesis import tts_to_wav as j_tts_to_wav
from wavernn_tpu.train.checkpoints import flat_to_tree
from wavernn_tpu_torch.cli import preprocess as cli_preprocess
from wavernn_tpu_torch.cli import train_tacotron as cli_train_tacotron
from wavernn_tpu_torch.compat.to_jax import (jax_flat_from_state_dict,
                                             tacotron_jax_key)
from wavernn_tpu_torch.config import Config, TacotronConfig, WaveRNNConfig
from wavernn_tpu_torch.data.dataset import (get_tts_datasets,
                                            get_vocoder_datasets)
from wavernn_tpu_torch.data.preprocess import preprocess
from wavernn_tpu_torch.dsp.audio import load_wav, save_wav
from wavernn_tpu_torch.dsp.griffinlim import (mel_to_stft,
                                              reconstruct_waveform)
from wavernn_tpu_torch.dsp.mel import db_to_amp, denormalize, \
    melspectrogram_np
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.paths import Workspace
from wavernn_tpu_torch.synthesis import gen_from_file, tts_to_wav
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.utils.display import (PALETTE, save_attention,
                                             save_spectrogram)

SR = 22050
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1)
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)
TEXT = "The birch canoe slid on the smooth planks."
LINES = ["The birch canoe slid on the smooth planks.",
         "Glue the sheet to the dark blue background.",
         "It's easy to tell the depth of a well.",
         "These days a chicken leg is a rare dish.",
         "Rice is often served in round bowls.",
         "The juice of lemons makes fine punch."]


def _corpus(root):
    """root/wavs/*.wav (sines and chirps, 0.3-0.6 s, one above full scale
    to take the peak normalisation) and root/metadata.csv."""
    rng = np.random.RandomState(11)
    (root / "wavs").mkdir(parents=True)
    rows = []
    for i, line in enumerate(LINES):
        t = np.arange(int(SR * (0.3 + 0.06 * i))) / SR
        f0 = 110.0 * (i + 1)
        y = (0.6 * np.sin(2 * np.pi * (f0 + 400 * t * (i % 2)) * t)
             + 0.01 * rng.randn(t.size))
        if i == 3:
            y = y * 1.8                     # past 1.0: float wav, peak-normed
            from scipy.io import wavfile
            wavfile.write(str(root / "wavs" / f"LJ{i:03d}.wav"), SR,
                          y.astype(np.float32))
        else:
            save_wav(y, root / "wavs" / f"LJ{i:03d}.wav", SR)
        rows.append(f"LJ{i:03d}|{line}|{line}")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return root / "wavs"


def _tree(data):
    return {p.relative_to(data).as_posix(): p.read_bytes()
            for p in sorted(data.rglob("*.npy")) + [data / "text_dict.pkl"]}


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_preprocess_writes_the_jax_package_bytes(tmp_path, mode):
    wavs = _corpus(tmp_path / "corpus")
    jcfg = JConfig(data_path=str(tmp_path / "jdata"), voc=JVoc(mode=mode))
    cfg = Config(data_path=str(tmp_path / "pdata"),
                 voc=WaveRNNConfig(mode=mode))
    jws = JWorkspace(jcfg.data_path, "v", "t", output_root=str(tmp_path))
    ws = Workspace(cfg.data_path, "v", "t", output_root=str(tmp_path))
    jds = j_preprocess(jcfg, jws, wav_path=wavs, n_workers=1,
                       log=lambda *a: None)
    ds = preprocess(cfg, ws, wav_path=wavs, n_workers=1, log=lambda *a: None)
    assert len(ds) == 6 and sorted(ds) == sorted(jds)
    with open(ws.data / "dataset.pkl", "rb") as f, \
            open(jws.data / "dataset.pkl", "rb") as g:
        assert sorted(pickle.load(f)) == sorted(pickle.load(g))
    got, want = _tree(ws.data), _tree(jws.data)
    assert sorted(got) == sorted(want) and len(got) == 13
    for name in want:
        assert got[name] == want[name], name
    q = np.load(ws.quant / "LJ001.npy")
    assert q.dtype == np.int64 and q.max() < (2 ** 16 if mode == "MOL"
                                              else 2 ** 9)
    assert np.load(ws.mel / "LJ001.npy").dtype == np.float32


def test_cli_preprocess_reads_wav_path_and_the_readers_take_it(tmp_path,
                                                               monkeypatch,
                                                               capsys):
    """``cli.preprocess`` with the hparams' wav_path (no --path), its table;
    the port's vocoder and TTS datasets read what it wrote, and the
    Tacotron trainer trains on it and plots the attention."""
    wavs = _corpus(tmp_path / "corpus")
    monkeypatch.chdir(tmp_path)
    hp = tmp_path / "hp.py"
    hp.write_text(f"wav_path = {str(wavs)!r}\n"
                  f"data_path = {str(tmp_path / 'data')!r}\n"
                  "voc_mode = 'RAW'\nvoc_test_samples = 2\n")
    cli_preprocess.main(["--hp_file", str(hp), "--num_workers", "1",
                         "--force_cpu"])
    out = capsys.readouterr().out
    assert "Sample Rate" in out and "Hop Length" in out
    assert "6 wav files found" in out and "Completed." in out
    cfg = Config.from_hparams_file(hp)
    assert cfg.wav_path == str(wavs) and Config().wav_path == "data/wavs"
    train, test = get_vocoder_datasets(tmp_path / "data", 2, cfg)
    x, y, m = next(iter(train))
    assert x.shape[0] == y.shape[0] == m.shape[0] == 2
    mel, quant = test[0]
    assert mel.shape[0] == 80 and quant.dtype == np.int64
    ds, attn_example = get_tts_datasets(tmp_path / "data", 2, 2, cfg)
    chars, mel_b, ids, lens = next(iter(ds))
    assert chars.shape[0] == 2 and mel_b.shape[1] == 80
    assert attn_example == "LJ005"              # the longest item
    # the Tacotron trainer on it: at each checkpoint the longest item's
    # attention (in every batch of 6) goes to attention/<step>.png
    with open(hp, "a") as f:
        f.write("".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items())
                + "tts_model_id = 'a12'\ntts_schedule = [(2, 1e-3, 2, 6)]\n"
                "tts_checkpoint_every = 1\n")
    cli_train_tacotron.main(["--hp_file", str(hp), "--force_cpu"])
    plots = tmp_path / "checkpoints" / "a12.tacotron" / "attention"
    assert sorted(p.name for p in plots.iterdir()) == ["1.png", "2.png"]
    assert (tmp_path / "checkpoints" / "a12.tacotron" / "mel_plots").is_dir()
    # the batch's padded text positions down, its 50 frames / r across
    idx, _ = _read_png(plots / "2.png")
    n_text = max(len(text_to_sequence(t, cfg.tts.cleaner_names))
                 for t in LINES)
    assert idx.shape == (n_text, 25)


def test_gen_from_file_wav_equals_its_mel(tmp_path):
    """A .wav through gen_from_file: its copy saved as the target, and the
    same wave as the .npy of melspectrogram_np(load_wav(x)) with the same
    generator seed."""
    cfg = Config(voc=WaveRNNConfig(**VOC))
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.reset_parameters(torch.Generator().manual_seed(3))
    voc.eval()
    t = np.arange(int(0.1 * SR)) / SR
    save_wav(0.5 * np.sin(2 * np.pi * 330 * t), tmp_path / "x.wav", SR)
    mel = melspectrogram_np(load_wav(tmp_path / "x.wav", SR), cfg.dsp)
    np.save(tmp_path / "x_mel.npy", mel)
    kw = dict(batched=True, target=550, overlap=275, cfg=cfg, step=4000,
              device="cpu")
    a = gen_from_file(voc, tmp_path / "x.wav", tmp_path / "out",
                      generator=torch.Generator().manual_seed(1), **kw)
    b = gen_from_file(voc, tmp_path / "x_mel.npy", tmp_path / "out",
                      generator=torch.Generator().manual_seed(1), **kw)
    assert a.shape == ((mel.shape[1] - 1) * 275,)
    np.testing.assert_array_equal(a, b)
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["__x__4k_steps_gen_batched_target550_overlap275.wav",
                     "__x__4k_steps_target.wav",
                     "__x_mel__4k_steps_gen_batched_target550_overlap275.wav"]
    np.testing.assert_allclose(
        load_wav(tmp_path / "out" / "__x__4k_steps_target.wav", SR),
        load_wav(tmp_path / "x.wav", SR), atol=0)
    with pytest.raises(ValueError, match=".flac"):
        gen_from_file(voc, tmp_path / "x.flac", tmp_path / "out", **kw)


def test_tts_to_wav_griffinlim_matches_jax():
    cfg = Config(tts=TacotronConfig(**TTS))
    tts = taco.Tacotron(cfg.tts, 80)
    tts.reset_parameters(torch.Generator().manual_seed(5))
    tts.eval()
    # the JAX tree of the same weights; its structure from eval_shape, which
    # traces init_tacotron without compiling each initialiser
    like = jax.eval_shape(lambda: jtaco.init_tacotron(
        jax.random.PRNGKey(0), JTTS(**TTS), 80))
    tts_p = flat_to_tree(jax_flat_from_state_dict(tts.state_dict(),
                                                  tacotron_jax_key), like)
    r, steps = 2, 24
    jcfg = JConfig(tts=JTTS(**TTS))
    want, m_j, _ = j_tts_to_wav(tts_p, None, TEXT, jcfg, r, steps=steps,
                                vocoder="griffinlim")
    want = np.asarray(want)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                      (1025, m_j.shape[1])))
    wav, m, attn = tts_to_wav(tts, None, TEXT, cfg, r, steps=steps,
                              device="cpu", vocoder="griffinlim",
                              gl_iters=32, gl_phase_u=u)
    assert m.shape == m_j.shape and attn.shape[0] == m.shape[1] // r
    np.testing.assert_allclose(m, m_j, atol=2e-3)
    # the wave is the port's Griffin-Lim of its own mel, read back once
    assert wav.dtype == np.float32 and wav.shape == want.shape
    np.testing.assert_array_equal(
        wav, reconstruct_waveform(m, cfg.dsp, device="cpu", phase_u=u))
    # the port's Griffin-Lim of the JAX mel against the JAX wave: the NNLS
    # within 5e-5 of its largest magnitude (measured 1.2e-5); the whole
    # inversion within 5e-3 (measured 2e-4 on a peak of 7e-3: on this quiet
    # mel the float32 differences of the NNLS and of the FFTs, amplified by
    # the momentum, reach ~3 % of the peak)
    amp = db_to_amp(denormalize(m_j.astype(np.float64))).astype(np.float32)
    S_j = J.mel_to_stft_jax(jnp.asarray(amp), jcfg.dsp)
    S = mel_to_stft(torch.from_numpy(amp), cfg.dsp)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j),
                               atol=5e-5 * float(jnp.abs(S_j).max()))
    gl = reconstruct_waveform(m_j, cfg.dsp, device="cpu", phase_u=u)
    np.testing.assert_allclose(gl, want, atol=5e-3)


def _read_png(path):
    """(indices (h, w) uint8, palette (256, 3)) of an 8-bit palette PNG."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 3) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()                   # filter type None
    return rows[:, 1:], np.frombuffer(chunks[b"PLTE"], np.uint8).reshape(-1, 3)


@pytest.mark.parametrize("kind", ["attention", "spectrogram"])
def test_png_savers_keep_the_array_s_order(tmp_path, kind):
    rng = np.random.RandomState(2)
    if kind == "attention":
        # (decoder steps, text positions), one clear peak per step
        A = rng.uniform(0, 0.1, (37, 11))
        A[np.arange(37), rng.randint(0, 11, 37)] = 1.0
        path = save_attention(torch.from_numpy(A), tmp_path / "a.wav")
        assert path.name == "a.wav.png"
        want = A.T                                     # text positions down
    else:
        M = rng.uniform(0, 0.1, (80, 50))
        M[rng.randint(0, 80, 50), np.arange(50)] = 1.0
        path = save_spectrogram(M, tmp_path / "m", length=40)
        want = np.flip(M, axis=0)[:, :40]              # highest bin on top
    idx, palette = _read_png(path)
    assert idx.shape == want.shape
    np.testing.assert_array_equal(palette, PALETTE)
    assert idx.max() == 255 and idx.min() == 0
    # each decoder step's (frame's) peak stays in its column and row
    np.testing.assert_array_equal(idx.argmax(axis=0), want.argmax(axis=0))
