"""Port parity: the DeepMind coarse/fine WaveRNN
(``wavernn_tpu_torch.models.deepmind``) against the JAX package's
``wavernn_tpu.models.deepmind`` on the CPU, through the weight bridge
(``compat/from_jax.deepmind_state_dict``).

Widths: hidden 64 (the cell's, forward_seq's and generate's parity) and the
reference's 896 (the parameter count and the bridge's strict load).
Inputs and the generator's uniforms: numpy from a seed, injected into both.

Tolerances (float32 on both sides; the differences are summation order):
- the cell's logits and hidden state, forward_seq's logits: 1e-5 x
  max(1, |reference|);
- generate with injected noise: the coarse and fine labels exactly (each an
  argmax of logits plus Gumbel noise, far from ties at these seeds), so the
  signal too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wavernn_tpu.models import deepmind as jdm
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import deepmind_state_dict
from wavernn_tpu_torch.models import deepmind as dm


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


def _models(hidden=64, seed=0):
    params = jdm.init_deepmind(jax.random.PRNGKey(seed), hidden)
    # nonzero gate biases, so the bridge's bias mapping is exercised
    rng = np.random.RandomState(seed)
    for k in ("bias_u", "bias_r", "bias_e"):
        params[k] = jnp.asarray(rng.randn(hidden).astype(np.float32) * 0.1)
    model = dm.DeepMindWaveRNN(hidden)
    model.load_state_dict(deepmind_state_dict(tree_to_flat(params)),
                          strict=True)
    return params, model


def test_cell_matches_jax():
    params, model = _models()
    rng = np.random.RandomState(1)
    prev_y = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    hidden = rng.randn(3, 64).astype(np.float32) * 0.5
    cur = rng.uniform(-1, 1, (3, 1)).astype(np.float32)
    want = jdm.cell(params, jnp.asarray(prev_y), jnp.asarray(hidden),
                    jnp.asarray(cur))
    with torch.no_grad():
        got = model.cell(torch.tensor(prev_y), torch.tensor(hidden),
                         torch.tensor(cur))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_forward_seq_matches_jax():
    params, model = _models()
    rng = np.random.RandomState(2)
    coarse = rng.randint(0, 256, (2, 17))
    fine = rng.randint(0, 256, (2, 17))
    oc_j, of_j = jdm.forward_seq(params, jnp.asarray(coarse),
                                 jnp.asarray(fine))
    with torch.no_grad():
        oc, of = model.forward_seq(torch.tensor(coarse), torch.tensor(fine))
    _close(oc, oc_j, 1e-5)
    _close(of, of_j, 1e-5)


def test_generate_with_injected_noise_matches_jax():
    params, model = _models()
    rng = np.random.RandomState(3)
    T, Q = 40, 256
    u_c = rng.uniform(1e-9, 1.0, (T, Q)).astype(np.float32)
    u_f = rng.uniform(1e-9, 1.0, (T, Q)).astype(np.float32)
    sig_j, c_j, f_j = jdm.generate(params, T, jax.random.PRNGKey(0),
                                   noise=(jnp.asarray(u_c), jnp.asarray(u_f)))
    sig, c, f = model.generate(T, noise=(torch.tensor(u_c),
                                         torch.tensor(u_f)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sig_j))
    # drawn from a generator: the same shapes and label range
    sig2, c2, f2 = model.generate(5, generator=torch.Generator().manual_seed(0))
    assert sig2.shape == c2.shape == f2.shape == (5,)
    assert float(c2.min()) >= 0 and float(c2.max()) <= 255


def test_parameter_count_and_strict_bridge():
    params = jdm.init_deepmind(jax.random.PRNGKey(0), 896)
    model = dm.DeepMindWaveRNN(896)
    n_jax = sum(int(np.prod(np.shape(v)))
                for v in tree_to_flat(params).values())
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax
    flat = tree_to_flat(params)
    model.load_state_dict(deepmind_state_dict(flat), strict=True)
    with pytest.raises(KeyError, match="not mapped"):
        deepmind_state_dict(dict(flat, extra=np.zeros(1)))
    missing = dict(flat)
    del missing["O3/b"]
    with pytest.raises(KeyError, match="lack"):
        deepmind_state_dict(missing)


def test_nll_loss_trains():
    _, model = _models(hidden=32)
    rng = np.random.RandomState(4)
    coarse = torch.tensor(rng.randint(0, 256, (2, 9)))
    fine = torch.tensor(rng.randint(0, 256, (2, 9)))
    loss = dm.nll_loss(model, coarse, fine)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(p.grad is not None for p in model.parameters())
