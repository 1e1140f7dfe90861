"""Port parity, serving vocoder: the sample loop's state I/O, the
materialized sample loop (B3's plain version), unbatched and
materialized-fold generation, ``generate_multi`` and streaming, against the
JAX package on the CPU.

Weights: JAX ``init_wavernn`` -> the port's weight bridge. Noise: the same
numpy uniforms on both sides. The JAX Pallas kernels run in interpret mode
with float32 compute, as the JAX package's own tests run them.

Tolerances: 1e-5 for the plain sample loop against JAX's scan (float32 on
both sides, summation order only); 2e-3 for samples and waves against a
JAX kernel or generation path (the JAX package's kernel-against-scan
bound, tests/test_polyphase.py:147-175) and 1e-5 for the state a kernel
snapshots; streamed samples equal the offline run exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu import streaming as jstream
from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops import pallas_gen as jpg
from wavernn_tpu.ops.fold import num_folds_for
from wavernn_tpu.ops.sample_loop import (
    generate_scan_with_state as j_scan_with_state)
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, DSPConfig, WaveRNNConfig
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen
from wavernn_tpu_torch.ops.sample_loop import generate_scan_with_state
from wavernn_tpu_torch.streaming import MultiStreamVocoder, StreamingVocoder

VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
HOP = 275


def _models(mode, seed=1):
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    model = wr.WaveRNN(WaveRNNConfig(mode=mode, **VOC), DSPConfig())
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    return jvoc, params, model.eval()


def _noise(rng, mode, T, B, n_classes=None):
    if mode == "MOL":
        return (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
                rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))
    return rng.uniform(1e-5, 1 - 1e-5, (T, B, n_classes or 512)) \
        .astype(np.float32)


def _t(noise):
    if isinstance(noise, tuple):
        return tuple(torch.from_numpy(u) for u in noise)
    return torch.from_numpy(noise)


def _j(noise):
    if isinstance(noise, tuple):
        return tuple(jnp.asarray(u) for u in noise)
    return jnp.asarray(noise)


def _col(noise, b):
    if isinstance(noise, tuple):
        return tuple(u[:, b:b + 1] for u in noise)
    return noise[:, b:b + 1]


def _cond(rng, B, T):
    """Random upsampled conditioning (B, T, n_mels), (B, T, 4A) and a
    state to resume from."""
    A = VOC["res_out_dims"] // 4
    R = VOC["rnn_dims"]
    return (rng.uniform(0, 1, (B, T, 80)).astype(np.float32),
            rng.uniform(-1, 1, (B, T, 4 * A)).astype(np.float32),
            (rng.uniform(-0.5, 0.5, (B, R)).astype(np.float32),
             rng.uniform(-0.5, 0.5, (B, R)).astype(np.float32),
             rng.uniform(-0.5, 0.5, (B,)).astype(np.float32)))


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_scan_with_state_matches_jax(mode):
    jvoc, params, model = _models(mode)
    rng = np.random.RandomState(0)
    B, T, s = 3, 40, 23
    mels_up, aux, state = _cond(rng, B, T)
    noise = _noise(rng, mode, T, B)
    core = model.core_weights()
    for snap_at in (s, None):
        want_y, want_st = j_scan_with_state(
            params, jnp.asarray(mels_up), jnp.asarray(aux), jvoc, 9,
            jax.random.PRNGKey(0), noise=_j(noise),
            init_state=tuple(map(jnp.asarray, state)),
            state_snapshot_at=snap_at)
        u = cuda_gen._split_noise(cuda_gen.noise_stream(_t(noise), T, mode),
                                  mode, 10)
        got_y, got_st = generate_scan_with_state(
            core, torch.from_numpy(mels_up), torch.from_numpy(aux), mode, u,
            tuple(map(torch.from_numpy, state)), snap_at)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   atol=1e-5)
        for g, w in zip(got_st, want_st):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_materialized_plain_matches_pallas_with_state(mode):
    """B3's plain version against the TPU kernel's state arm, at a T that
    is not a multiple of the kernel's 128-step chunk."""
    jvoc, params, model = _models(mode, seed=3)
    rng = np.random.RandomState(1)
    B, T, s = 2, 150, 97
    mels_up, aux, state = _cond(rng, B, T)
    noise = _noise(rng, mode, T, B)
    want_y, want_st = jpg.generate_pallas_with_state(
        params, jnp.asarray(mels_up), jnp.asarray(aux), jvoc, 9,
        jax.random.PRNGKey(0), noise=_j(noise), compute_dtype=jnp.float32,
        interpret=True, init_state=tuple(map(jnp.asarray, state)),
        state_snapshot_at=s)
    got_y, got_st = cuda_gen.generate_materialized(
        model.core_weights(), torch.from_numpy(mels_up),
        torch.from_numpy(aux), mode, noise=_t(noise),
        init_state=tuple(map(torch.from_numpy, state)), state_snapshot_at=s)
    assert got_y.shape == (B, T)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-3)
    for g, w in zip(got_st, want_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_materialized_chained_launches_equal_one():
    """The streaming contract: T steps equal T1 then T - T1 steps resumed
    from the returned state, under the same noise, exactly."""
    _, _, model = _models("MOL", seed=4)
    rng = np.random.RandomState(2)
    B, T, T1 = 2, 60, 25
    mels_up, aux, _ = _cond(rng, B, T)
    mu, au = torch.from_numpy(mels_up), torch.from_numpy(aux)
    u = _t(_noise(rng, "MOL", T, B))
    core = model.core_weights()
    y, st = cuda_gen.generate_materialized(core, mu, au, "MOL", noise=u)
    y1, st1 = cuda_gen.generate_materialized(
        core, mu[:, :T1], au[:, :T1], "MOL", noise=tuple(v[:T1] for v in u))
    y2, st2 = cuda_gen.generate_materialized(
        core, mu[:, T1:], au[:, T1:], "MOL", noise=tuple(v[T1:] for v in u),
        init_state=st1)
    _, snap = cuda_gen.generate_materialized(core, mu, au, "MOL", noise=u,
                                             state_snapshot_at=T1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    for a, b in zip(st, st2):
        assert torch.equal(a, b)
    for a, c in zip(st1, snap):
        assert torch.equal(a, c)


@pytest.mark.parametrize("batched", [False, True])
def test_generate_unbatched_and_materialized_folds_match_jax(batched):
    """``generate(batched=False)``, and ``generate`` with target 1000 /
    overlap 100 (not hop multiples: the materialized fold path), against
    JAX ``generate(use_pallas=False)`` over the wave."""
    jvoc, params, model = _models("MOL", seed=2)
    rng = np.random.RandomState(3)
    n_frames = 22    # the wave outlasts the 20-frame fade
    mels = rng.uniform(0, 1, (1, 80, n_frames)).astype(np.float32)
    target, overlap = 1000, 100
    if batched:
        B = num_folds_for(n_frames * HOP, target, overlap)
        T = target + 2 * overlap
    else:
        B, T = 1, n_frames * HOP
    noise = _noise(rng, "MOL", T, B)
    want = jwr.generate(params, mels, jvoc, JDSP(), jax.random.PRNGKey(0),
                        batched=batched, target=target, overlap=overlap,
                        use_pallas=False, noise=_j(noise))
    got = wr.generate(model, mels, batched=batched, target=target,
                      overlap=overlap, noise=_t(noise), device="cpu")
    assert got.dtype == torch.float64
    assert got.shape == want.shape == ((n_frames - 1) * HOP,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_generate_multi_matches_jax(monkeypatch):
    """Two utterances of different lengths, every fold in one launch, the
    float32 post-pass on the device, no tail fade."""
    jvoc, params, model = _models("MOL", seed=5)
    rng = np.random.RandomState(4)
    target, overlap = 4 * HOP, HOP
    mels = [rng.uniform(0, 1, (1, 80, n)).astype(np.float32)
            for n in (14, 9)]
    B = sum(num_folds_for(m.shape[-1] * HOP, target, overlap) for m in mels)
    noise = _noise(rng, "MOL", target + 2 * overlap, B)
    # the JAX serving program calls its kernel in bfloat16; hold it to
    # float32 as its tests do, and keep its compile cache to this test
    fused = jpg.generate_pallas_fused
    monkeypatch.setattr(jpg, "generate_pallas_fused",
                        lambda *a, **k: fused(*a, **{
                            **k, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(jwr, "_MULTI_PROG_CACHE", {})
    want = jwr.generate_multi(params, mels, jvoc, JDSP(),
                              jax.random.PRNGKey(0), target=target,
                              overlap=overlap, use_pallas=True,
                              interpret=True, noise=_j(noise),
                              device_out=True, tail_fade=False)
    got = wr.generate_multi(model, mels, target=target, overlap=overlap,
                            noise=_t(noise), device="cpu", device_out=True,
                            tail_fade=False)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)
    host = wr.generate_multi(model, mels, target=target, overlap=overlap,
                             noise=_t(noise), device="cpu", tail_fade=False)
    for h, g in zip(host, got):
        assert h.dtype == np.float64
        np.testing.assert_allclose(h, g.numpy(), atol=1e-5)


def _offline(model, mels, noise, mode):
    """The unbatched offline reference: pad, upsample the whole mel, one
    run of B3's plain version over frames * hop steps."""
    m = torch.nn.functional.pad(torch.from_numpy(mels)[None], (2, 2))
    with torch.no_grad():
        mels_up, aux = model.upsample(m)
        y, _ = cuda_gen.generate_materialized_ref(
            model.core_weights(), mels_up, aux, mode, noise=_t(noise))
    return y[0].numpy()


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_streaming_equals_offline_and_jax(mode):
    jvoc, params, model = _models(mode, seed=6)
    rng = np.random.RandomState(5)
    frames = 16   # not a multiple of chunk_frames: the flush tail runs
    mels = rng.uniform(0.2, 0.8, (80, frames)).astype(np.float32)
    T = frames * HOP
    noise = _noise(rng, mode, T, 1)
    want = _offline(model, mels, noise, mode)

    sv = StreamingVocoder(model, chunk_frames=7, mu_law=False,
                          noise=_t(noise), device="cpu")
    got = [sv.feed(mels[:, :1]), sv.feed(mels[:, 1:10]),
           sv.feed(mels[:, 10:12]), sv.feed(mels[:, 12:]), sv.flush()]
    got = np.concatenate(got)
    assert got.shape == want.shape == (T,)
    np.testing.assert_array_equal(got, want)

    jsv = jstream.StreamingVocoder(params, jvoc, JDSP(),
                                   jax.random.PRNGKey(0), chunk_frames=7,
                                   mu_law=False, use_pallas=False,
                                   noise=_j(noise))
    jgot = np.concatenate([jsv.feed(mels[:, :10]), jsv.feed(mels[:, 10:]),
                           jsv.flush()])
    np.testing.assert_allclose(got, jgot, atol=2e-3)


def test_multistream_lanes_equal_solo_streams():
    """Three lanes fed out of step, with ride-along blocks. Lane isolation
    is exact: lane 0's audio does not change when its neighbours carry other
    audio on another schedule. Against its solo stream on the same noise
    column each lane agrees within 1e-5, not exactly: the CPU's batched
    products round a row differently at batch 3 than at batch 1 (by one
    float32 ulp here; the kernel's per-row sums do not depend on the
    batch). A reset lane starts over."""
    _, _, model = _models("MOL", seed=7)
    rng = np.random.RandomState(6)
    frames = [9, 5, 7]
    mels = [rng.uniform(0.2, 0.8, (80, f)).astype(np.float32)
            for f in frames]
    other = [None] + [rng.uniform(0.0, 1.0, (80, f)).astype(np.float32)
                      for f in frames[1:]]
    noise = _noise(rng, "MOL", max(frames) * HOP, 3)

    def run(lanes, schedule):
        msv = MultiStreamVocoder(model, 3, chunk_frames=4, noise=_t(noise),
                                 device="cpu")
        got = [[] for _ in range(3)]
        for b, lo, hi, drain in schedule:
            if b is None:
                out = msv.poll()
            else:
                m = mels[0] if b == 0 else lanes[b]
                out = msv.feed(b, m[:, lo:hi], drain=drain)
            for sb, y in out.items():
                got[sb].append(y)
        for b in (1, 0, 2):
            for sb, y in msv.flush(b).items():
                got[sb].append(y)
        return msv, [np.concatenate(g) for g in got]

    msv, a = run(mels, [(0, 0, 6, True), (2, 0, 7, False), (1, 0, 3, True),
                        (None, 0, None, True), (0, 6, 9, True),
                        (1, 3, 5, True)])
    _, b_ = run(other, [(1, 0, 5, True), (0, 0, 6, True), (2, 0, 4, True),
                        (0, 6, 9, True), (2, 4, 7, True)])
    np.testing.assert_array_equal(a[0], b_[0])

    def solo(b):
        sv = StreamingVocoder(model, chunk_frames=4, noise=_t(_col(noise, b)),
                              device="cpu")
        return np.concatenate([sv.feed(mels[b]), sv.flush()])

    for b in range(3):
        assert a[b].shape == (frames[b] * HOP,)
        np.testing.assert_allclose(a[b], solo(b), atol=1e-5)

    # a recycled lane starts from zero state at noise position 0
    msv.reset(1)
    again = np.concatenate([msv.feed(1, mels[1]).get(1, np.zeros(0)),
                            msv.flush(1)[1]])
    np.testing.assert_array_equal(again, a[1])
