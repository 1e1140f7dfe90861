"""Port parity: the batched decode's plain version (``ops/cuda_taco.
decode_batch_ref``, the spec the B8 kernel is held to) against the JAX
package's own batched decode kernels on the CPU: ``decode_pallas_batch``
(B <= 8) and ``decode_pallas_stacked`` (B > 8), both in interpret mode.

Weights: JAX ``init_tacotron`` -> numpy -> the port's weight bridge
(``compat/from_jax.state_dict_from_jax``), the decoder at 256 and the
LSTMs narrowed to 64 as in tests/test_torch_port_tacotron.py; the same
encoder outputs (the JAX length-aware encoder's, pad positions zeroed)
feed both sides. Each batch has mixed text lengths and a stop threshold
taken from the plain version's own no-stop run, so that its rows stop at
different groups (chip_smoke.stop_threshold's rule).

Tolerances (float32 on both sides, different summation order, fed back
through the recurrence): mel 2e-4, attention 2e-5, n_valid identical.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import TacotronConfig as JTTS
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.ops.pallas_taco import (decode_pallas_batch,
                                         decode_pallas_stacked)
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, TacotronConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.ops import cuda_taco

N_MELS = 80
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)
MEL_TOL, ATT_TOL = 2e-4, 2e-5


def _batch(lens, seed):
    """(JAX config, params, port decoder weights, enc, encp, text mask) for
    a batch of random texts of lengths ``lens``."""
    jtts = JTTS(**TTS)
    params = jtaco.init_tacotron(jax.random.PRNGKey(seed), jtts, N_MELS)
    model = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    rng = np.random.RandomState(seed)
    T = max(lens)
    x = jnp.asarray(np.stack([np.pad(rng.randint(1, 148, (n,)), (0, T - n))
                              for n in lens]))
    lens_a = jnp.asarray(lens)
    enc, _ = jtaco.encoder_apply(params["encoder"], x,
                                 jax.random.PRNGKey(3), False, jtts.dropout,
                                 lens=lens_a)
    encp = jtaco.L.linear(params["encoder_proj"], enc)
    tm = (jnp.arange(T)[None, :] < lens_a[:, None]).astype(jnp.float32)
    enc, encp = enc * tm[..., None], encp * tm[..., None]
    return (jtts, params, model.decoder_weights(), np.array(enc),
            np.array(encp), np.array(tm))


def _split_threshold(mel, r):
    """The threshold halfway between two of the rows' group maxima that
    stops the most rows at distinct groups (row b stops at its first group
    g with g*r > 10 whose maximum is below it); (threshold, stops)."""
    B, _, steps = mel.shape
    G = steps // r
    peaks = mel.reshape(B, N_MELS, G, r).amax(dim=(1, 3))
    vals = sorted(set(peaks[:, 6:].flatten().tolist()))
    best = None
    for lo, hi in zip(vals[:-1], vals[1:]):
        thr = (lo + hi) / 2
        stops = [next((g + 1 for g in range(G) if g * r > 10
                       and peaks[b, g] < thr), G) for b in range(B)]
        key = (len(set(stops)), hi - lo)
        if best is None or key > best[0]:
            best = (key, thr, stops)
    return best[1], best[2]


def _parity(kernel, lens, seed, r=2, steps=40):
    jtts, params, dec, enc, encp, tm = _batch(lens, seed)
    args = (dec, torch.from_numpy(enc), torch.from_numpy(encp),
            torch.from_numpy(tm), r, steps, N_MELS, jtts.max_r)
    with torch.no_grad():
        free = cuda_taco.decode_batch_ref(*args, -1e30)[0]
    thr, stops = _split_threshold(free, r)
    assert len(set(stops)) >= 3, stops   # the rows stop at different groups
    mel_k, attn_k, nv_k = kernel(params, jnp.asarray(enc), jnp.asarray(encp),
                                 jnp.asarray(tm),
                                 dataclasses.replace(jtts, stop_threshold=thr),
                                 r, steps, N_MELS, interpret=True)
    with torch.no_grad():
        mel_t, attn_t, nv_t = cuda_taco.decode_batch_ref(*args, thr)
    assert mel_t.shape == (len(lens), N_MELS, steps)
    assert attn_t.shape == (len(lens), steps // r, max(lens))
    np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_k))
    assert sorted(set(nv_t.tolist())) == sorted(set(stops))
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_k), atol=MEL_TOL)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_k),
                               atol=ATT_TOL)
    # a stopped row replays its frozen-state output to the end
    for b, n in enumerate(nv_t.tolist()):
        if n < steps // r:
            np.testing.assert_array_equal(mel_t[b, :, n * r:(n + 1) * r],
                                          mel_t[b, :, -r:])


def test_decode_batch_ref_matches_decode_pallas_batch():
    """B 3 (the batched kernel's B <= 8 arm), mixed lengths, per-row stops
    at different groups."""
    _parity(decode_pallas_batch, [7, 13, 4], seed=6)


def test_decode_batch_ref_matches_decode_pallas_stacked():
    """B 9 (the lane-stacked kernel, B > 8), mixed lengths, per-row stops
    at different groups."""
    _parity(decode_pallas_stacked, [7, 11, 4, 9, 13, 5, 8, 10, 6], seed=6)
