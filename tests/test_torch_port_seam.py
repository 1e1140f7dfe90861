"""Port parity: exact-seam generation on one device (the port's
``parallel/gen_sharded.py``) and the plain version of B4b, the fused
sample loop with state I/O, against the JAX package on the CPU.

Weights: JAX ``init_wavernn`` -> numpy -> the port's weight bridge.
Noise: the same numpy uniforms on both sides. The JAX side runs its fused
Pallas kernels in interpret mode with float32 compute, as its own tests do
(tests/test_seam.py:181-184), and its scan twin on sample-rate folds.

Tolerance 2e-4 on samples and states, as the fused loop's plain version is
held (tests/test_torch_port_vocoder.py): float32 on both sides, summation
order only, fed back through the autoregressive loop. Fused samples are
compared where they survive the trim to the wave (the last fold's padded
tail is not part of any output). The crossfaded waves are held within
2e-3, the JAX package's bound for its kernel's waveform against its scan
(tests/test_polyphase.py:147-175).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops import fold as jF
from wavernn_tpu.ops.pallas_gen import (generate_pallas_fused,
                                        generate_pallas_fused_with_state)
from wavernn_tpu.ops.sample_loop import generate_scan
from wavernn_tpu.parallel import gen_sharded as jgs
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, DSPConfig, WaveRNNConfig
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen
from wavernn_tpu_torch.ops import fold as F
from wavernn_tpu_torch.ops import polyphase as P
from wavernn_tpu_torch.parallel import gen_sharded as gs

VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
HOP = 275
TARGET, OVERLAP = 2 * HOP, HOP          # frame-aligned: B1 / B4b
TARGET_M, OVERLAP_M = 500, 200          # not hop multiples: B3


def _models(mode, seed=1):
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    model = wr.WaveRNN(WaveRNNConfig(mode=mode, **VOC), DSPConfig())
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    return jvoc, params, model.eval()


def _noise(rng, mode, T, B, n_classes=512):
    if mode == "MOL":
        return (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
                rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))
    return rng.uniform(1e-5, 1 - 1e-5, (T, B, n_classes)).astype(np.float32)


def _jn(noise):
    return tuple(map(jnp.asarray, noise)) if isinstance(noise, tuple) \
        else jnp.asarray(noise)


def _tn(noise):
    return tuple(map(torch.from_numpy, noise)) if isinstance(noise, tuple) \
        else torch.from_numpy(noise)


def _frames(params, jvoc, mels, target, overlap):
    """JAX's frame prep (gen_sharded._fused_frame_prep): (frames, phi,
    geometry, fold_chunks)."""
    frames, fold_chunks, geo, phi, _ = jgs._fused_frame_prep(
        params, jnp.asarray(mels), jvoc, JDSP(), target, overlap)
    return frames, phi, geo, fold_chunks


def _kept(x, target, overlap, wave_len):
    return np.asarray(jgs.concat_folds(jnp.asarray(np.asarray(x)), target,
                                       overlap, wave_len))


def test_seam_shift_and_concat_folds_match_jax():
    rng = np.random.RandomState(3)
    state = tuple(rng.randn(*s).astype(np.float32)
                  for s in ((4, 6), (4, 6), (4,)))
    want = jgs._seam_shift(tuple(map(jnp.asarray, state)))
    got = gs._seam_shift(tuple(map(torch.from_numpy, state)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got[0][0].any() and torch.equal(got[0][1],
                                               torch.from_numpy(state[0][0]))
    y = rng.randn(3, 40).astype(np.float32)
    for wave_len in (95, 100, 200):
        np.testing.assert_array_equal(
            gs.concat_folds(torch.from_numpy(y), 20, 10, wave_len).numpy(),
            np.asarray(jgs.concat_folds(jnp.asarray(y), 20, 10, wave_len)))


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_fused_state_plain_matches_pallas_fused_with_state(mode):
    """B4b's plain version with a state in and a snapshot inside the
    launch, against the JAX state kernel in interpret mode."""
    jvoc, params, model = _models(mode)
    rng = np.random.RandomState(0)
    n_fr = 10
    mels = rng.uniform(0, 1, (1, 80, n_fr)).astype(np.float32)
    frames, phi, geo, fold_chunks = _frames(params, jvoc, mels, TARGET,
                                            OVERLAP)
    B, T = frames.shape[1], fold_chunks * HOP
    state = (rng.randn(B, 32).astype(np.float32) * 0.3,
             rng.randn(B, 32).astype(np.float32) * 0.3,
             rng.uniform(-1, 1, B).astype(np.float32))
    noise = _noise(rng, mode, T, B)
    snap_at = 700
    want, want_st = generate_pallas_fused_with_state(
        params, frames, phi, jvoc, 9, jax.random.PRNGKey(0), HOP, -geo.d_lo,
        fold_chunks, noise=_jn(noise), compute_dtype=jnp.float32,
        interpret=True, init_state=tuple(map(jnp.asarray, state)),
        state_snapshot_at=snap_at)
    got, got_st = cuda_gen.generate_fused_with_state(
        model.core_weights(), torch.from_numpy(np.array(frames)),
        torch.from_numpy(np.array(phi)), HOP, -geo.d_lo, fold_chunks, mode,
        noise=_tn(noise), init_state=tuple(map(torch.from_numpy, state)),
        state_snapshot_at=snap_at)
    assert got.shape == (B, T)
    wave_len = (n_fr - 1) * HOP
    np.testing.assert_allclose(_kept(got, TARGET, OVERLAP, wave_len),
                               _kept(want, TARGET, OVERLAP, wave_len),
                               atol=2e-4)
    for a, b in zip(got_st, want_st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def test_exact_seam_fused_matches_jax():
    jvoc, params, model = _models("MOL", seed=2)
    rng = np.random.RandomState(1)
    n_fr = 10
    mels = rng.uniform(0, 1, (1, 80, n_fr)).astype(np.float32)
    frames, phi, geo, fold_chunks = _frames(params, jvoc, mels, TARGET,
                                            OVERLAP)
    B, T = frames.shape[1], fold_chunks * HOP
    noise = _noise(rng, "MOL", T, B)
    want, want_err = jgs.generate_exact_seam_fused(
        params, frames, phi, jvoc, 9, jax.random.PRNGKey(0), HOP, -geo.d_lo,
        fold_chunks, TARGET, OVERLAP, seam_passes=2, noise=_jn(noise),
        compute_dtype=jnp.float32, interpret=True)
    got, got_err = gs.generate_exact_seam_fused(
        model.core_weights(), torch.from_numpy(np.array(frames)),
        torch.from_numpy(np.array(phi)), HOP, -geo.d_lo, fold_chunks, "MOL",
        TARGET, OVERLAP, seam_passes=2, noise=_tn(noise))
    wave_len = (n_fr - 1) * HOP
    np.testing.assert_allclose(_kept(got, TARGET, OVERLAP, wave_len),
                               _kept(want, TARGET, OVERLAP, wave_len),
                               atol=2e-4)
    assert got_err.shape == (2,)
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err),
                               atol=2e-5)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_exact_seam_materialized_matches_jax(mode):
    jvoc, params, model = _models(mode, seed=3)
    rng = np.random.RandomState(2)
    B, L = 3, TARGET_M + 2 * OVERLAP_M
    mf = rng.randn(B, L, 80).astype(np.float32) * 0.3
    af = rng.randn(B, L, 16).astype(np.float32) * 0.3
    noise = _noise(rng, mode, L, B)
    want, want_err = jgs.generate_exact_seam(
        params, jnp.asarray(mf), jnp.asarray(af), jvoc, 9,
        jax.random.PRNGKey(0), TARGET_M, OVERLAP_M, seam_passes=2,
        noise=_jn(noise))
    got, got_err = gs.generate_exact_seam(
        model.core_weights(), torch.from_numpy(mf), torch.from_numpy(af),
        mode, TARGET_M, OVERLAP_M, seam_passes=2, noise=_tn(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err),
                               atol=2e-5)


def _sharded_case(mode, seed, n_fr=12):
    jvoc, params, model = _models(mode, seed)
    rng = np.random.RandomState(seed)
    mels = rng.uniform(0, 1, (1, 80, n_fr)).astype(np.float32)
    return jvoc, params, model, rng, mels, (n_fr - 1) * HOP


@pytest.mark.parametrize("branch", ["crossfade_fused", "seam_fused",
                                    "seam_materialized",
                                    "crossfade_materialized"])
def test_generate_sharded_branches_match_jax(branch):
    """Each one-device branch of ``generate_sharded`` against the JAX
    package's pieces composed as its branch composes them, on injected
    noise (JAX's ``generate_sharded`` draws its own)."""
    jvoc, params, model, rng, mels, wave_len = _sharded_case("MOL", 4)
    fused = branch.endswith("fused")
    seam = branch.startswith("seam")
    target, overlap = (TARGET, OVERLAP) if fused else (TARGET_M, OVERLAP_M)
    if fused:
        frames, phi, geo, fold_chunks = _frames(params, jvoc, mels, target,
                                                overlap)
        B, L = frames.shape[1], fold_chunks * HOP
    else:
        mels_up, aux, _ = jwr.upsample_apply(
            params["upsample"], jnp.asarray(np.pad(
                mels, ((0, 0), (0, 0), (2, 2)))), jvoc, training=False)
        mf = jF.fold_with_overlap(mels_up, target, overlap)
        af = jF.fold_with_overlap(aux, target, overlap)
        B, L = mf.shape[0], mf.shape[1]
    noise = _noise(rng, "MOL", L, B)
    if fused and seam:
        samples, _ = jgs.generate_exact_seam_fused(
            params, frames, phi, jvoc, 9, jax.random.PRNGKey(0), HOP,
            -geo.d_lo, fold_chunks, target, overlap, seam_passes=2,
            noise=_jn(noise), compute_dtype=jnp.float32, interpret=True)
    elif fused:
        samples = generate_pallas_fused(
            params, frames, phi, jvoc, 9, jax.random.PRNGKey(0), HOP,
            -geo.d_lo, fold_chunks, noise=_jn(noise),
            compute_dtype=jnp.float32, interpret=True)
    elif seam:
        samples, _ = jgs.generate_exact_seam(
            params, mf, af, jvoc, 9, jax.random.PRNGKey(0), target, overlap,
            seam_passes=2, noise=_jn(noise))
    else:
        samples = generate_scan(params, mf, af, jvoc, 9,
                                jax.random.PRNGKey(0), noise=_jn(noise))
    want = np.asarray(
        jgs.concat_folds(samples, target, overlap, wave_len) if seam
        else jF.xfade_and_unfold_jax(samples, overlap)[:wave_len])
    gs.last_stats.clear()
    got = gs.generate_sharded(model, mels, target=target, overlap=overlap,
                              seam_passes=2 if seam else 0,
                              noise=_tn(noise), device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (wave_len,)
    np.testing.assert_allclose(got, want, atol=2e-3)
    if branch == "crossfade_fused":
        assert gs.last_stats["devices"] == 1
        assert gs.last_stats["num_folds"] == B
        assert gs.last_stats["fold_imbalance"] == 0.0
    else:
        assert gs.last_stats == {}
    dev_out = gs.generate_sharded(model, mels, target=target,
                                  overlap=overlap,
                                  seam_passes=2 if seam else 0,
                                  noise=_tn(noise), device="cpu",
                                  device_out=True)
    assert isinstance(dev_out, torch.Tensor)
    np.testing.assert_array_equal(dev_out.numpy(), got)


def test_generate_sharded_raw_has_no_mu_law_and_no_fade():
    """The reference's output convention: RAW samples come out on the
    class grid, not mu-law decoded, and the tail is not faded, where
    ``generate_fast`` decodes and fades the same draws. 24 frames, so
    fold 0's body lies before the 20-frame fade."""
    _, _, model, rng, mels, wave_len = _sharded_case("RAW", 5, n_fr=24)
    B = F.num_folds_for(24 * HOP, TARGET, OVERLAP)
    noise = _tn(_noise(rng, "RAW", TARGET + 2 * OVERLAP, B))
    got = gs.generate_sharded(model, mels, noise=noise, target=TARGET,
                              overlap=OVERLAP, device="cpu")
    fast = wr.generate_fast(model, mels, noise=noise, target=TARGET,
                            overlap=OVERLAP, device="cpu").numpy()
    body = slice(OVERLAP, TARGET + OVERLAP)   # fold 0, no crossfade there
    idx = (got[body] + 1.0) * 511 / 2.0
    np.testing.assert_allclose(idx, np.round(idx), atol=1e-3)
    np.testing.assert_allclose(
        fast[body], wr.mu_law_decode(torch.from_numpy(got[body]),
                                     512).numpy(), atol=1e-6)
    assert fast[-1] == 0.0 and got[-1] != 0.0   # RAW never samples 0


def test_sequential_oracle_on_the_port():
    """tests/test_seam.py:21-65 on the port alone: on an utterance that
    folds exactly, with noise laid out so that fold i's local step j is
    global step i*seg + j, num_folds - 1 passes of either seam reproduce
    one sequential row."""
    _, _, model = _models("MOL", seed=6)
    rng = np.random.RandomState(6)
    core = model.core_weights()
    n, seg = 3, TARGET + OVERLAP
    total = n * seg + OVERLAP                  # folds exactly, no padding
    u_mix = rng.uniform(1e-5, 1 - 1e-5, (total, 1, 10)).astype(np.float32)
    u_s = rng.uniform(1e-5, 1 - 1e-5, (total, 1)).astype(np.float32)
    L = TARGET + 2 * OVERLAP
    g = np.arange(n)[None, :] * seg + np.arange(L)[:, None]   # (L, n)
    noise_f = (torch.from_numpy(u_mix[g, 0]), torch.from_numpy(u_s[g, 0]))
    noise_1 = (torch.from_numpy(u_mix), torch.from_numpy(u_s))
    # materialized: sample-rate conditioning of the whole utterance
    mels_up = torch.from_numpy(rng.randn(1, total, 80).astype(np.float32)
                               * 0.3)
    aux = torch.from_numpy(rng.randn(1, total, 16).astype(np.float32) * 0.3)
    seq = cuda_gen.generate_materialized(core, mels_up, aux, "MOL",
                                         noise=noise_1)[0][0]
    y, errs = gs.generate_exact_seam(
        core, F.fold_with_overlap(mels_up, TARGET, OVERLAP),
        F.fold_with_overlap(aux, TARGET, OVERLAP), "MOL", TARGET, OVERLAP,
        seam_passes=n - 1, noise=noise_f)
    np.testing.assert_allclose(gs.concat_folds(y, TARGET, OVERLAP,
                                               total).numpy(),
                               seq.numpy(), atol=2e-4)
    assert float(errs[-1]) <= float(errs[0]) + 1e-6
    # fused: the same folds at frame rate against one row over the span
    n_fr = total // HOP
    mels = torch.from_numpy(rng.uniform(0, 1, (1, 80, n_fr))
                            .astype(np.float32))
    mels_p = torch.nn.functional.pad(mels, (2, 2))
    with torch.no_grad():
        frames, phi, geo, fold_chunks = wr.fused_conditioning(
            model, mels_p, total, TARGET, OVERLAP)
        one = P.build_folded_frames(mels_p[0].t(),
                                    model.upsample.resnet(mels_p)[0].t(), 1,
                                    0, n_fr, geo.K, geo.d_lo)
    assert frames.shape[1] == n
    seq = cuda_gen.generate_fused(core, one, phi, HOP, -geo.d_lo, n_fr,
                                  "MOL", noise=noise_1)[0]
    y, errs = gs.generate_exact_seam_fused(
        core, frames, phi, HOP, -geo.d_lo, fold_chunks, "MOL", TARGET,
        OVERLAP, seam_passes=n - 1, noise=noise_f)
    np.testing.assert_allclose(gs.concat_folds(y, TARGET, OVERLAP,
                                               total).numpy(),
                               seq.numpy(), atol=2e-4)
    assert float(errs[-1]) <= float(errs[0]) + 1e-6


def test_mesh_raises_naming_a11b():
    """``mesh=`` is ported (tests/test_torch_port_mesh.py runs it); what
    is not a DeviceMesh with a "data" dimension still raises, naming
    what it must be."""
    _, _, model = _models("MOL")
    with pytest.raises(TypeError, match="DeviceMesh"):
        gs.generate_sharded(model, np.zeros((1, 80, 4), np.float32),
                            mesh=object(), device="cpu")


def test_generate_sharded_needs_cuda_unless_cpu_is_asked():
    _, _, model = _models("MOL")
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gs.generate_sharded(model, np.zeros((1, 80, 4), np.float32))
