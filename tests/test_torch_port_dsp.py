"""Port: the DSP stack (dsp/audio.py, dsp/mel.py, dsp/griffinlim.py)
against the JAX package's on the CPU, on the same seeded numpy inputs.

Tolerances, each stated at its assert:
- the mel filterbank and the host helpers: exact (copies of the same numpy);
- the STFT: 1e-5 of a spectrum whose peak is ~25 (float32 FFTs, PocketFFT
  against XLA's); the normalised mel: 5e-4, tests/test_dsp.py's bound for
  the JAX package's own on-device mel against its numpy one;
- the NNLS: 1e-5 relative to the largest magnitude (200 float32
  multiplicative updates);
- Griffin-Lim with JAX's own PRNGKey(0) phase draw injected: 1e-6 at 4
  iterations; at 32 the float32 differences are amplified by the momentum,
  measured 1.6e-5 on a peak of 0.31, held to 1e-4; reconstruct_waveform
  (NNLS + 32 iterations at the default config) as its docstring says.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu import dsp as J
from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu_torch import dsp as P
from wavernn_tpu_torch.config import DSPConfig
from wavernn_tpu_torch.dsp.mel import filterbank_tensor

CFG, JCFG = DSPConfig(), JDSP()
SMALL = dict(n_fft=512, hop_length=128, win_length=256, num_mels=40)


def _signal(seed, hops, cfg=CFG):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.5, 0.5, cfg.hop_length * hops).astype(np.float32)


def _phase_u(shape, seed=0):
    """The draw griffinlim_jax makes inside (PRNGKey(seed), uniform)."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))


def test_mel_filterbank_equals_jax():
    got = P.mel_filterbank(CFG.sample_rate, CFG.n_fft, CFG.num_mels,
                           CFG.fmin)
    want = J.mel_filterbank(JCFG.sample_rate, JCFG.n_fft, JCFG.num_mels,
                            JCFG.fmin)
    assert got.dtype == np.float64 and got.shape == (80, 1025)
    np.testing.assert_array_equal(got, want)                 # exact
    fb = filterbank_tensor(CFG, torch.device("cpu"), torch.float64)
    np.testing.assert_array_equal(fb.numpy(), want)


def test_host_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, 500)
    for name, args in (("float_2_label", (x, 9)), ("encode_mu_law", (x, 512)),
                       ("encode_16bits", (x,)), ("pre_emphasis", (x,)),
                       ("de_emphasis", (x,)), ("amp_to_db", (np.abs(x),)),
                       ("normalize", (x * 100 - 50,)),
                       ("denormalize", (x,)), ("db_to_amp", (x * 20,))):
        np.testing.assert_array_equal(getattr(P, name)(*args),
                                      getattr(J, name)(*args), err_msg=name)
    q = np.round(x * 32767).astype(np.int64)
    for a, b in zip(P.split_signal(q), J.split_signal(q)):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(P.combine_signal(*P.split_signal(q)), q)
    P.save_wav(x * 0.9, tmp_path / "x.wav", CFG.sample_rate)
    np.testing.assert_array_equal(P.load_wav(tmp_path / "x.wav"),
                                  J.load_wav(tmp_path / "x.wav"))
    with pytest.raises(ValueError, match="resampling"):
        P.load_wav(tmp_path / "x.wav", 16000)
    y = _signal(1, 12)
    np.testing.assert_array_equal(P.spectrogram_np(y, CFG),
                                  J.spectrogram_np(y, JCFG))


def test_stft_and_melspectrogram_match_jax():
    y = _signal(0, 20)
    D_np = P.stft_np(y, CFG.n_fft, CFG.hop_length, CFG.win_length)
    D_jax = np.asarray(J.stft_jax(y, CFG.n_fft, CFG.hop_length,
                                  CFG.win_length))
    D = P.stft(y, CFG.n_fft, CFG.hop_length, CFG.win_length, device="cpu")
    assert D.dtype == torch.complex64 and D.shape == D_np.shape == (1025, 21)
    scale = np.abs(D_np).max()
    np.testing.assert_allclose(D.numpy(), D_jax, atol=1e-5 * scale)
    np.testing.assert_allclose(D.numpy(), D_np, atol=1e-5 * scale)
    D64 = P.stft(y, CFG.n_fft, CFG.hop_length, CFG.win_length, device="cpu",
                 dtype=torch.float64)
    np.testing.assert_allclose(D64.numpy(), D_np, atol=1e-10)  # float64
    # batched over leading axes: each row its own STFT
    yb = np.stack([y, _signal(1, 20)])[None]
    Db = P.stft(torch.from_numpy(yb), CFG.n_fft, CFG.hop_length,
                CFG.win_length, device="cpu")
    assert Db.shape == (1, 2, 1025, 21)
    np.testing.assert_array_equal(Db[0, 0].numpy(), D.numpy())

    m = P.melspectrogram(yb, CFG, device="cpu")
    m_jax = np.asarray(J.melspectrogram_jax(jnp.asarray(yb), JCFG))
    assert m.shape == m_jax.shape == (1, 2, 80, 21)
    assert m.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), m_jax, atol=5e-4)
    np.testing.assert_allclose(m[0, 0].numpy(), P.melspectrogram_np(y, CFG),
                               atol=5e-4)


def test_istft_matches_jax_and_round_trips():
    y = _signal(2, 20)
    D_jax = J.stft_jax(y, CFG.n_fft, CFG.hop_length, CFG.win_length)
    want = np.asarray(J.istft_jax(D_jax, CFG.n_fft, CFG.hop_length,
                                  CFG.win_length, length=len(y)))
    got = P.istft(torch.from_numpy(np.array(D_jax)), CFG.n_fft,
                  CFG.hop_length, CFG.win_length, length=len(y))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # untrimmed length: (frames - 1) * hop, as istft_jax
    full = P.istft(torch.from_numpy(np.array(D_jax)), CFG.n_fft,
                   CFG.hop_length, CFG.win_length)
    assert full.shape == (20 * CFG.hop_length,)
    # round trip in float64 through the port's own STFT
    D64 = P.stft(y, CFG.n_fft, CFG.hop_length, CFG.win_length, device="cpu",
                 dtype=torch.float64)
    back = P.istft(D64, CFG.n_fft, CFG.hop_length, CFG.win_length,
                   length=len(y))
    assert back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), y, atol=1e-10)


def test_mel_to_stft_matches_jax():
    mel = P.melspectrogram_np(_signal(4, 20), CFG)
    amp = P.db_to_amp(P.denormalize(mel.astype(np.float64))).astype(
        np.float32)
    want = np.asarray(J.mel_to_stft_jax(jnp.asarray(amp), JCFG))
    got = P.mel_to_stft(torch.from_numpy(amp), CFG)
    assert got.shape == want.shape == (1025, 21)
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_iter,tol", [(4, 1e-6), (32, 1e-4)])
def test_griffinlim_matches_jax(n_iter, tol):
    cfg, jcfg = DSPConfig(**SMALL), JDSP(**SMALL)
    S = np.random.RandomState(5).uniform(0, 1, (257, 30)).astype(np.float32)
    u = _phase_u(S.shape)
    want = np.asarray(J.griffinlim_jax(jnp.asarray(S), jcfg, n_iter=n_iter))
    got = P.griffinlim(torch.from_numpy(S), cfg, n_iter=n_iter, phase_u=u)
    # float32 / complex64 throughout on the CPU, never promoted
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    # the default initial phase is a fixed seed-0 draw
    a = P.griffinlim(torch.from_numpy(S), cfg, n_iter=1)
    b = P.griffinlim(torch.from_numpy(S), cfg, n_iter=1,
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_reconstruct_waveform_matches_jax():
    """End to end the NNLS's float32 drift (its 200 updates of an
    ill-posed solve) is what Griffin-Lim's momentum amplifies: over seeds
    0-7 of this input, largest differences of 3e-5 to 1.6e-3 on peaks of
    ~0.7, RMS differences up to 2e-4 of the wave's RMS. Held to 5e-3 and
    1e-3 of the RMS (here 1.8e-4 and 8e-5); Griffin-Lim itself, from the
    JAX package's NNLS output, to 1e-4 at this default config (here
    5e-6)."""
    mel = np.random.RandomState(6).uniform(0, 1, (80, 40)).astype(np.float32)
    u = _phase_u((1025, 40))
    want = J.reconstruct_waveform(mel, JCFG, n_iter=32)
    got = P.reconstruct_waveform(mel, CFG, n_iter=32, device="cpu",
                                 phase_u=u)
    assert got.dtype == np.float32 and got.shape == want.shape == (39 * 275,)
    np.testing.assert_allclose(got, want, atol=5e-3)
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.sqrt(np.mean((got - want).astype(np.float64) ** 2)) \
        <= 1e-3 * rms
    amp = P.db_to_amp(P.denormalize(mel.astype(np.float64)))
    S = J.mel_to_stft_jax(jnp.asarray(amp, dtype=jnp.float32), JCFG)
    gl = P.griffinlim(torch.from_numpy(np.array(S)), CFG, n_iter=32,
                      phase_u=u)
    np.testing.assert_allclose(
        gl.numpy(), np.asarray(J.griffinlim_jax(S, JCFG, n_iter=32)),
        atol=1e-4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the guard "
                    "on a machine without CUDA")
def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    y = _signal(0, 8)
    for call in (lambda: P.stft(y, 512, 128, 256),
                 lambda: P.melspectrogram(y, CFG),
                 lambda: P.reconstruct_waveform(np.zeros((80, 4)), CFG)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
