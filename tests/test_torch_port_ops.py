"""Port parity: the PyTorch ops of wavernn_tpu_torch against the JAX
package's on the CPU, at small sizes.

Inputs come from numpy seeds and go to both sides. Tolerance: atol 1e-5
for float32 arithmetic (the two frameworks sum in different orders); the
fold, polyphase index maths and the float64 crossfade match exactly (to
float64 rounding).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.compat import native
from wavernn_tpu.models import distribution as jdist
from wavernn_tpu.ops import fold as jfold
from wavernn_tpu.ops import layers as jL
from wavernn_tpu.ops import polyphase as jP
from wavernn_tpu_torch.models import distribution as tdist
from wavernn_tpu_torch.ops import _build
from wavernn_tpu_torch.ops import fold as tfold
from wavernn_tpu_torch.ops import layers as tL
from wavernn_tpu_torch.ops import polyphase as tP

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _n(x):
    return np.asarray(x)


def _gru_params(rng, i, h):
    return {k: rng.uniform(-0.3, 0.3, s).astype(np.float32) for k, s in
            (("wi", (i, 3 * h)), ("wh", (h, 3 * h)), ("bi", (3 * h,)),
             ("bh", (3 * h,)))}


def _torch_rnn(p):
    return (_t(p["wi"].T), _t(p["wh"].T), _t(p["bi"]), _t(p["bh"]))


def test_linear_conv_batchnorm():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7).astype(np.float32)
    p = {"w": rng.randn(7, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    np.testing.assert_allclose(
        tL.linear(_t(x), _t(p["w"].T), _t(p["b"])).numpy(),
        _n(jL.linear(p, x)), atol=ATOL)

    c = {"w": rng.randn(6, 5, 3).astype(np.float32),
         "b": rng.randn(6).astype(np.float32)}
    np.testing.assert_allclose(
        tL.conv1d(_t(x), _t(c["w"]), _t(c["b"]), padding=1).numpy(),
        _n(jL.conv1d(c, x, padding=1)), atol=ATOL)

    bn = {"scale": rng.rand(5).astype(np.float32) + 0.5,
          "bias": rng.randn(5).astype(np.float32),
          "mean": rng.randn(5).astype(np.float32),
          "var": rng.rand(5).astype(np.float32) + 0.1}
    want, _ = jL.batchnorm(bn, x, training=False)
    got = tL.batchnorm(_t(x), _t(bn["scale"]), _t(bn["bias"]),
                       _t(bn["mean"]), _t(bn["var"]))
    np.testing.assert_allclose(got.numpy(), _n(want), atol=ATOL)


def test_gru_lstm_cells():
    rng = np.random.RandomState(1)
    B, I, H = 3, 6, 5
    x = rng.randn(B, I).astype(np.float32)
    h = rng.randn(B, H).astype(np.float32)
    p = _gru_params(rng, I, H)
    np.testing.assert_allclose(
        tL.gru_cell(_t(x), _t(h), *_torch_rnn(p)).numpy(),
        _n(jL.gru_cell(p, x, h)), atol=ATOL)

    c = rng.randn(B, H).astype(np.float32)
    q = {k: rng.uniform(-0.3, 0.3, s).astype(np.float32) for k, s in
         (("wi", (I, 4 * H)), ("wh", (H, 4 * H)), ("bi", (4 * H,)),
          ("bh", (4 * H,)))}
    h_j, c_j = jL.lstm_cell(q, x, (h, c))
    h_t, c_t = tL.lstm_cell(_t(x), (_t(h), _t(c)), *_torch_rnn(q))
    np.testing.assert_allclose(h_t.numpy(), _n(h_j), atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), _n(c_j), atol=ATOL)


@pytest.mark.parametrize("with_lens", [False, True])
def test_bigru(with_lens):
    rng = np.random.RandomState(2)
    B, T, I, H = 3, 9, 4, 5
    xs = rng.randn(B, T, I).astype(np.float32)
    pf, pb = _gru_params(rng, I, H), _gru_params(rng, I, H)
    lens = np.array([9, 4, 6]) if with_lens else None
    want = jL.bigru(pf, pb, xs, lens=None if lens is None else jnp.asarray(lens))
    got = tL.bigru(_t(xs), _torch_rnn(pf), _torch_rnn(pb),
                   lens=None if lens is None else torch.from_numpy(lens))
    want, got = _n(want), got.numpy()
    if lens is None:
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:   # pad positions are garbage on both sides
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL)


def test_fold_and_xfade():
    rng = np.random.RandomState(3)
    target, overlap = 40, 12
    x = rng.randn(1, 137, 3).astype(np.float32)
    folded = tfold.fold_with_overlap(_t(x), target, overlap)
    np.testing.assert_array_equal(folded.numpy(),
                                  _n(jfold.fold_with_overlap(x, target,
                                                             overlap)))
    assert folded.shape[0] == tfold.num_folds_for(137, target, overlap)

    y = rng.randn(5, target + 2 * overlap)
    got = tfold.xfade_and_unfold(torch.from_numpy(y), overlap).numpy()
    np.testing.assert_allclose(got, native.xfade_and_unfold(y, target,
                                                            overlap),
                               rtol=0, atol=1e-12)


def test_polyphase_tables_and_frames():
    geo = tP.geometry((5, 5, 11), pad=2)
    assert (geo.hop, geo.K, geo.d_lo) == (275, 5, 0)
    assert geo == tuple(jP.geometry((5, 5, 11), pad=2))

    rng = np.random.RandomState(4)
    ws = [rng.uniform(0.05, 0.2, (1, 1, 1, 2 * s + 1)).astype(np.float32)
          for s in (5, 5, 11)]
    jgeo = jP.geometry((5, 5, 11), 2)
    want = jP.phi_table([{"w": jnp.asarray(w)} for w in ws], (5, 5, 11),
                        jgeo)
    got = tP.phi_table([_t(w) for w in ws], (5, 5, 11), geo)
    np.testing.assert_allclose(got.numpy(), _n(want), atol=ATOL)

    T, target, overlap = 10, 4 * 275, 275
    nf, stride_f, chunks, _ = tP.fold_geometry(T * 275, target, overlap, 275)
    assert (nf, stride_f, chunks) == jP.fold_geometry(T * 275, target,
                                                      overlap, 275)[:3]
    mel = rng.randn(T + 4, 3).astype(np.float32)
    aux = rng.randn(T, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tP.build_folded_frames(_t(mel), _t(aux), nf, stride_f, chunks, 5,
                               0).numpy(),
        _n(jP.build_folded_frames(mel, aux, nf, stride_f, chunks, 5, 0)))


def test_samplers():
    rng = np.random.RandomState(5)
    y = rng.randn(6, 4, 30).astype(np.float32) * 2
    u_mix = rng.uniform(1e-5, 1 - 1e-5, (6, 4, 10)).astype(np.float32)
    u_s = rng.uniform(1e-5, 1 - 1e-5, (6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tdist.sample_from_discretized_mix_logistic_with_noise(
            _t(y), _t(u_mix), _t(u_s)).numpy(),
        _n(jdist.sample_from_discretized_mix_logistic_with_noise(
            y, u_mix, u_s)), atol=ATOL)

    logits = rng.randn(6, 4, 512).astype(np.float32)
    u = rng.uniform(1e-9, 1.0, (6, 4, 512)).astype(np.float32)
    np.testing.assert_array_equal(
        tdist.sample_raw_categorical_with_noise(_t(logits), _t(u)).numpy(),
        _n(jdist.sample_raw_categorical_with_noise(logits, u)))


def test_kernel_operands_prepared_once_per_weight_set():
    """The kernels' wrappers cast and split weights once per weight set:
    reused for fresh views of the same parameters, prepared anew after an
    in-place update or for another key."""
    lin = torch.nn.Linear(4, 3)
    made = []

    def make():
        made.append(1)
        return lin.weight.detach().t().contiguous()

    def views():
        return {"w": lin.weight.detach(), "b": lin.bias.detach()}

    first = _build.prepared("test", views(), torch.float32, make)
    assert _build.prepared("test", views(), torch.float32, make) is first
    assert len(made) == 1
    _build.prepared("test", views(), torch.bfloat16, make)
    assert len(made) == 2
    lin.load_state_dict({"weight": torch.ones(3, 4), "bias": torch.zeros(3)})
    again = _build.prepared("test", views(), torch.bfloat16, make)
    assert len(made) == 3
    torch.testing.assert_close(again, torch.ones(4, 3))
