"""Port parity: the GRU training recurrence (kernel B5's plain versions,
``wavernn_tpu_torch/ops/cuda_gru.py``) against the JAX package's
``gru_seq_tm`` run in interpret mode, on the CPU.

Inputs are made by numpy from a seed and handed to both sides.

Tolerances:
- forward ``ys`` within 2e-5, and the gradients dgi, dwh, dbh, dh0 under
  one shared cotangent within atol = rtol = 1e-4: the bounds the JAX
  package's own tests use for its kernel against its scan
  (tests/test_pallas_gru.py:27-63); both sides are float32 and differ in
  summation order only;
- bfloat16 streams: gradients within 5e-2 of the largest entry, the JAX
  package's bf16 bound (tests/test_pallas_gru.py:66-85): a one-ulp
  rounding difference of h (2**-8 relative) is carried through the steps;
- float64 ``gradcheck`` at a tiny size at its default tolerances, and the
  hand-written backward ``gru_seq_bwd_ref`` against autograd of the plain
  forward ``gru_seq_ref`` within 1e-10 (float64, same arithmetic).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.ops.pallas_gru import gru_seq_tm as j_gru_seq_tm
from wavernn_tpu_torch.ops import cuda_gru


def _data(seed, T, B=8, H=64):
    rng = np.random.RandomState(seed)
    gi = rng.randn(T, B, 3 * H).astype(np.float32) * 0.5
    wh = rng.randn(H, 3 * H).astype(np.float32) * 0.05
    bh = rng.randn(3 * H).astype(np.float32) * 0.05
    h0 = rng.randn(B, H).astype(np.float32) * 0.1
    co = rng.randn(T, B, H).astype(np.float32) * 0.1
    return gi, wh, bh, h0, co


def _jax_grads(arrays, dtype):
    gi, wh, bh, h0, co = (jnp.asarray(a, dtype) for a in arrays)

    def loss(*a):
        return jnp.sum(j_gru_seq_tm(*a, 16, True).astype(jnp.float32)
                       * co.astype(jnp.float32))

    ys = jax.jit(partial(j_gru_seq_tm, chunk=16, interpret=True))(
        gi, wh, bh, h0)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(gi, wh, bh, h0)
    return (np.asarray(ys, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _port_grads(arrays, dtype):
    gi, wh, bh, h0, co = (torch.from_numpy(a).to(dtype) for a in arrays)
    leaves = [t.requires_grad_() for t in (gi, wh, bh, h0)]
    ys = cuda_gru.gru_seq_tm(*leaves)
    (ys.float() * co.float()).sum().backward()
    return (ys.detach().float().numpy(),
            [t.grad.float().numpy() for t in leaves])


@pytest.mark.parametrize("T", [37, 29])
def test_forward_and_grads_match_jax_interpret(T):
    arrays = _data(T, T)
    ys_j, g_j = _jax_grads(arrays, jnp.float32)
    ys_p, g_p = _port_grads(arrays, torch.float32)
    np.testing.assert_allclose(ys_p, ys_j, atol=2e-5)
    for a, b, name in zip(g_p, g_j, ("dgi", "dwh", "dbh", "dh0")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_bf16_streams_close_to_jax():
    arrays = _data(3, 37)
    _, g_j = _jax_grads(arrays, jnp.bfloat16)
    ys_p, g_p = _port_grads(arrays, torch.bfloat16)
    assert np.isfinite(ys_p).all()
    for a, b, name in zip(g_p, g_j, ("dgi", "dwh", "dbh", "dh0")):
        scale = np.abs(b).max() + 1e-6
        assert np.abs(a - b).max() / scale < 5e-2, name


def test_bf16_stream_dtypes():
    """Streams in the input dtype, dh0 back in h0's, bh's gradient in
    bh's (``_fwd_impl``/``_bwd_impl``)."""
    gi, wh, bh, h0, co = (torch.from_numpy(a) for a in _data(4, 5, B=2, H=8))
    gi, wh, h0 = gi.bfloat16(), wh.bfloat16(), h0.bfloat16()
    ys, sv = cuda_gru.gru_seq_ref(gi, wh, bh, h0)
    assert ys.dtype == sv.dtype == torch.bfloat16
    assert sv.shape == (5, 2, 32)
    dgi, dgh, dh0 = cuda_gru.gru_seq_bwd_ref(sv, ys, wh, h0, co.bfloat16())
    assert dgi.dtype == dgh.dtype == torch.bfloat16
    assert dh0.dtype == torch.float32
    # the two streams differ only in the n slot
    assert torch.equal(dgi[..., :16], dgh[..., :16])


def _tiny64(seed):
    g = torch.Generator().manual_seed(seed)
    T, B, H = 6, 3, 5
    return (torch.randn(T, B, 3 * H, generator=g, dtype=torch.float64) * 0.5,
            torch.randn(H, 3 * H, generator=g, dtype=torch.float64) * 0.3,
            torch.randn(3 * H, generator=g, dtype=torch.float64) * 0.1,
            torch.randn(B, H, generator=g, dtype=torch.float64) * 0.1)


def test_gradcheck_float64():
    args = [t.requires_grad_() for t in _tiny64(0)]
    assert torch.autograd.gradcheck(cuda_gru.gru_seq_tm, args)


def test_bwd_ref_matches_autograd_of_ref():
    gi, wh, bh, h0 = [t.requires_grad_() for t in _tiny64(1)]
    ys, sv = cuda_gru.gru_seq_ref(gi, wh, bh, h0)
    dys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(2),
                      dtype=torch.float64)
    want = torch.autograd.grad(ys, (gi, wh, bh, h0), dys)
    dgi, dgh, dh0 = cuda_gru.gru_seq_bwd_ref(sv.detach(), ys.detach(),
                                             wh.detach(), h0.detach(), dys)
    dwh, dbh = cuda_gru.weight_grads(ys.detach(), h0.detach(), dgh,
                                     wh.dtype, bh.dtype)
    for got, ref, name in zip((dgi, dwh, dbh, dh0), want,
                              ("dgi", "dwh", "dbh", "dh0")):
        torch.testing.assert_close(got, ref, atol=1e-10, rtol=1e-10,
                                   msg=name)


def test_cuda_tensor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    gi, wh, bh, h0 = _tiny64(3)
    with pytest.raises((RuntimeError, AssertionError)):
        cuda_gru.gru_seq_tm(gi.float().to("cuda"), wh.float(), bh.float(),
                            h0.float())
