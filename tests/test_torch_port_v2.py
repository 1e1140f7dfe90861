"""Port parity: B10, the sample loop on pre-projected streams
(``ops/cuda_gen2.py``), against the JAX package's ``generate_pallas_v2``
in interpret mode, on the CPU.

Weights: JAX ``init_wavernn`` -> numpy -> the port's weight bridge. Noise:
the same numpy uniforms on both sides. Both sides multiply float32
matrices (``compute_dtype`` float32).

Tolerances. float32 streams: 2e-4, summation order only, as
tests/test_pallas_gen.py:77 holds the TPU kernel against its scan. bfloat16
streams on both sides: each side rounds its own float32 projections, which
differ in summation order, so now and then one stream element rounds to the
neighbouring bfloat16 value (2**-8 relative) and the trajectories part; at
least 99 % of samples within 1e-3, the rule chip_smoke.py holds the
bfloat16 kernels to.
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
from wavernn_tpu.ops.pallas_gen2 import generate_pallas_v2
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, DSPConfig, WaveRNNConfig
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen, cuda_gen2

VOC = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=32,
           res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
B, T = 4, 150


def _case(mode, seed):
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    model = wr.WaveRNN(WaveRNNConfig(mode=mode, **VOC), DSPConfig())
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    rng = np.random.RandomState(seed)
    mels_up = rng.randn(B, T, 80).astype(np.float32) * 0.3
    aux = rng.randn(B, T, 32).astype(np.float32) * 0.3
    if mode == "MOL":
        noise = (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
                 rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))
    else:
        noise = rng.uniform(1e-5, 1 - 1e-5, (T, B, 512)).astype(np.float32)
    return jvoc, params, model.core_weights(), mels_up, aux, noise


def _both(mode, seed, stream_dtype):
    jvoc, params, core, mels_up, aux, noise = _case(mode, seed)
    jnoise = (tuple(map(jnp.asarray, noise)) if mode == "MOL"
              else jnp.asarray(noise))
    tnoise = (tuple(map(torch.from_numpy, noise)) if mode == "MOL"
              else torch.from_numpy(noise))
    want = np.asarray(generate_pallas_v2(
        params, jnp.asarray(mels_up), jnp.asarray(aux), jvoc, 9,
        jax.random.PRNGKey(0), noise=jnoise, chunk=50,
        compute_dtype=jnp.float32,
        stream_dtype=jnp.bfloat16 if stream_dtype == torch.bfloat16
        else jnp.float32, interpret=True))
    got = cuda_gen2.generate_v2_ref(
        core, torch.from_numpy(mels_up), torch.from_numpy(aux), mode,
        noise=tnoise, stream_dtype=stream_dtype)
    return got, want, (core, mels_up, aux, tnoise)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_v2_plain_matches_pallas_v2_f32_streams(mode):
    got, want, (core, mels_up, aux, tnoise) = _both(mode, 1, torch.float32)
    assert got.shape == want.shape == (B, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    # float32 streams: the same function as the port's plain sample loop
    scan = cuda_gen.generate_materialized_ref(
        core, torch.from_numpy(mels_up), torch.from_numpy(aux), mode,
        noise=tnoise)[0]
    np.testing.assert_allclose(got.numpy(), scan.numpy(), atol=2e-4)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_v2_plain_matches_pallas_v2_bf16_streams(mode):
    got, want, (core, mels_up, aux, tnoise) = _both(mode, 2, torch.bfloat16)
    share = float(np.mean(np.abs(got.numpy() - want) <= 1e-3))
    assert share >= 0.99, share
    # the entry point on CPU tensors is the plain version
    cpu = cuda_gen2.generate_v2(core, torch.from_numpy(mels_up),
                                torch.from_numpy(aux), mode, noise=tnoise)
    assert torch.equal(cpu, got)


def test_v2_streams_round_where_the_tpu_kernel_does():
    """The streams are the float32 projections rounded once to the stream
    type; the folded vectors stay float32."""
    _, _, core, mels_up, aux, _ = _case("MOL", 3)
    mu, au = torch.from_numpy(mels_up), torch.from_numpy(aux)
    s16, v16 = cuda_gen2.v2_streams(core, mu, au, torch.bfloat16)
    s32, v32 = cuda_gen2.v2_streams(core, mu, au, torch.float32)
    for a, b, width in zip(s16, s32, (64, 192, 192, 64, 64)):
        assert a.dtype == torch.bfloat16 and a.shape == (T, B, width)
        assert torch.equal(a, b.to(torch.bfloat16))
    for a, b in zip(v16, v32):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    wi1 = core["rnn1.weight_ih_l0"]
    torch.testing.assert_close(v32[1], wi1 @ core["I.weight"][:, 0])


def test_counter_noise_when_none_is_injected():
    """Production noise: the counter hash keyed by the seed, the same draws
    as injecting ``counter_uniforms`` of that seed."""
    _, _, core, mels_up, aux, _ = _case("RAW", 4)
    mu, au = torch.from_numpy(mels_up[:, :40]), torch.from_numpy(aux[:, :40])
    u = cuda_gen.counter_uniforms(11, 40, B, 512, False, "cpu")
    a = cuda_gen2.generate_v2(core, mu, au, "RAW", seed=11)
    b = cuda_gen2.generate_v2(core, mu, au, "RAW", noise=u)
    assert torch.equal(a, b)
    assert not torch.equal(a, cuda_gen2.generate_v2(core, mu, au, "RAW",
                                                    seed=12))


def test_stream_dtype_is_checked():
    _, _, core, mels_up, aux, _ = _case("MOL", 5)
    with pytest.raises(TypeError, match="stream_dtype"):
        cuda_gen2.generate_v2(core, torch.from_numpy(mels_up),
                              torch.from_numpy(aux), "MOL",
                              stream_dtype=torch.float16)
