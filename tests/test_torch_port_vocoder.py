"""Port parity: the fused sample loop's plain version and the port's
vocoder ``generate`` against the JAX package, on the CPU.

Weights: JAX ``init_wavernn`` -> numpy -> the port's weight bridge.
Noise: the same numpy uniforms on both sides. The JAX side runs the fused
Pallas kernel in interpret mode with float32 compute, as its own tests do.

Tolerances: 2e-4 for the sample loop against the fused kernel (both
float32; the difference is summation order, fed back through the
autoregressive loop), on the samples that survive the crossfade trim
(the last fold's padded tail differs by design, pallas_gen.py:832-838);
2e-3 for the waveform, the JAX package's own bound for its kernel against
its scan (tests/test_polyphase.py:147-175).
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
from wavernn_tpu.ops import polyphase as jP
from wavernn_tpu.ops.fold import num_folds_for
from wavernn_tpu.ops.pallas_gen import generate_pallas_fused
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, DSPConfig, WaveRNNConfig
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen

VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16,
           res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
T_FRAMES, TARGET, OVERLAP = 14, 4 * 275, 275


def _models(mode, seed=1):
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    model = wr.WaveRNN(WaveRNNConfig(mode=mode, **VOC), DSPConfig())
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    return jvoc, params, model


def _noise(rng, mode, T, B, n_classes):
    if mode == "MOL":
        return (rng.uniform(1e-5, 1 - 1e-5, (T, B, n_classes // 3))
                .astype(np.float32),
                rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))
    return rng.uniform(1e-5, 1 - 1e-5, (T, B, n_classes)).astype(np.float32)


def _torch_noise(noise):
    if isinstance(noise, tuple):
        return tuple(torch.from_numpy(u) for u in noise)
    return torch.from_numpy(noise)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_fused_plain_matches_pallas_fused(mode):
    jvoc, params, model = _models(mode)
    rng = np.random.RandomState(0)
    mels = rng.uniform(0, 1, (1, 80, T_FRAMES)).astype(np.float32)
    mels_p = np.pad(mels, ((0, 0), (0, 0), (2, 2)))
    geo = jP.geometry(jvoc.upsample_factors, jvoc.pad)
    total_len = T_FRAMES * geo.hop
    B, stride_f, fold_chunks, fold_len = jP.fold_geometry(
        total_len, TARGET, OVERLAP, geo.hop)
    phi = jP.phi_table(params["upsample"]["up_convs"], jvoc.upsample_factors,
                       geo)
    aux_fr, _ = jwr.melresnet_apply(params["upsample"]["resnet"],
                                    jnp.asarray(mels_p), training=False)
    frames = jP.build_folded_frames(
        jnp.asarray(mels_p[0].T), jnp.swapaxes(aux_fr[0], 0, 1), B, stride_f,
        fold_chunks, geo.K, geo.d_lo)
    noise = _noise(rng, mode, fold_len, B, jvoc.n_classes(9))
    want = np.asarray(generate_pallas_fused(
        params, frames, phi, jvoc, 9, jax.random.PRNGKey(0), geo.hop,
        -geo.d_lo, fold_chunks,
        noise=tuple(map(jnp.asarray, noise)) if mode == "MOL"
        else jnp.asarray(noise),
        compute_dtype=jnp.float32, interpret=True))

    got = cuda_gen.generate_fused(
        model.core_weights(), torch.from_numpy(np.array(frames)),
        torch.from_numpy(np.array(phi)), geo.hop, -geo.d_lo, fold_chunks,
        mode, noise=_torch_noise(noise)).numpy()
    assert got.shape == want.shape == (B, fold_len)
    for b in range(B):
        valid = min(fold_len, max(0, total_len - b * (TARGET + OVERLAP)))
        np.testing.assert_allclose(got[b, :valid], want[b, :valid],
                                   atol=2e-4, err_msg=f"fold {b}")


def test_generate_matches_generate_fast():
    """The whole vocoder: conditioning, sample loop, crossfade, tail fade.
    22 frames, so the wave outlasts the 20-frame fade: below that the JAX
    package's two paths fade differently (generate_fast takes the tail of
    the full-length ramp, generate's host fade a shorter ramp) and the
    port follows generate."""
    jvoc, params, model = _models("MOL", seed=2)
    rng = np.random.RandomState(1)
    n_frames = 22
    mels = rng.uniform(0, 1, (1, 80, n_frames)).astype(np.float32)
    B = num_folds_for(n_frames * 275, TARGET, OVERLAP)
    noise = _noise(rng, "MOL", TARGET + 2 * OVERLAP, B, 30)
    want = np.asarray(jwr.generate_fast(
        params, mels, jvoc, JDSP(), jax.random.PRNGKey(0), target=TARGET,
        overlap=OVERLAP, use_pallas=True, interpret=True,
        noise=tuple(map(jnp.asarray, noise)), compute_dtype=jnp.float32))
    got = wr.generate(model, mels, target=TARGET, overlap=OVERLAP,
                      noise=_torch_noise(noise), device="cpu")
    assert got.dtype == torch.float64
    assert got.shape == want.shape == ((n_frames - 1) * 275,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_counter_noise_in_range_and_seeded():
    u = cuda_gen.counter_uniforms(7, 50, 3, 11, True, "cpu")
    assert u.shape == (50, 3, 11) and u.dtype == torch.float32
    assert float(u.min()) >= 1e-5 and float(u.max()) <= 1 - 1e-5
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert torch.equal(u, cuda_gen.counter_uniforms(7, 50, 3, 11, True, "cpu"))
    assert not torch.equal(u, cuda_gen.counter_uniforms(8, 50, 3, 11, True,
                                                        "cpu"))
    raw = cuda_gen.counter_uniforms(7, 20, 2, 512, False, "cpu")
    assert float(raw.min()) > 0 and float(raw.max()) < 1
