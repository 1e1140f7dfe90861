"""Port parity: the Tacotron encoder, attention, decoder step, the plain
decode (the decode kernel's plain version) and ``generate`` against the
JAX package on the CPU.

Weights: JAX ``init_tacotron`` -> numpy -> the port's weight bridge. The
decoder is at 256 (the prenet's 128 outputs plus the 2*128 encoder
context fix it there); the LSTMs are narrowed to 64, the encoder and
postnet kept small. The JAX decode kernel runs in interpret mode.

Tolerances (float32 on both sides, different summation order, fed back
through the recurrence): mel 2e-4, attention 2e-5, linear 2e-3, and the
stop group (n_valid) identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import TacotronConfig as JTTS
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.ops.pallas_taco import decode_pallas
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, TacotronConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.ops import cuda_taco

N_MELS = 80
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)


def _models(seed=0, **kw):
    jtts = JTTS(**TTS, **kw)
    params = jtaco.init_tacotron(jax.random.PRNGKey(seed), jtts, N_MELS)
    model = taco.Tacotron(TacotronConfig(**TTS, **kw), N_MELS)
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    return jtts, params, model


def _encode(params, model, T_text, seed):
    ids = np.random.RandomState(seed).randint(1, 148, (1, T_text))
    enc, _ = jtaco.encoder_apply(params["encoder"], jnp.asarray(ids),
                                 jax.random.PRNGKey(3), False, 0.5)
    encp = jtaco.L.linear(params["encoder_proj"], enc)
    with torch.no_grad():
        t_enc = model.encoder(torch.from_numpy(ids))
        t_encp = t_enc @ model.encoder_proj.weight.t()
    return ids, (np.array(enc), np.array(encp)), (t_enc, t_encp)


def test_encoder_attention_and_decoder_step():
    jtts, params, model = _models()
    _, (enc, encp), (t_enc, t_encp) = _encode(params, model, 23, 0)
    np.testing.assert_allclose(t_enc.numpy(), enc, atol=2e-5)
    np.testing.assert_allclose(t_encp.numpy(), encp, atol=2e-5)

    rng = np.random.RandomState(1)
    T = enc.shape[1]
    dec = model.decoder_weights()
    state = jtaco.DecoderState(*(
        jnp.asarray(rng.uniform(0, s, shape).astype(np.float32))
        for s, shape in ((0.5, (1, 256)), (0.5, (1, 64)), (0.5, (1, 64)),
                         (0.5, (1, 64)), (0.5, (1, 64)), (0.5, (1, 256)),
                         (1.0, (1, T)), (0.1, (1, T)), (0.5, (1, N_MELS)))))
    t_state = taco.DecoderState(*(torch.from_numpy(np.array(s))
                                  for s in state))
    t_enc_in = torch.from_numpy(enc)
    t_encp_in = torch.from_numpy(encp)

    want = jtaco.lsa_scores(params["decoder"]["attn"], encp,
                            state.attn_hidden, state.cumulative,
                            state.attention)
    with torch.no_grad():
        got = taco.lsa_scores(dec, t_encp_in, t_state.attn_hidden,
                              t_state.cumulative, t_state.attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    r = 3
    mels_j, scores_j, new_j = jtaco.decoder_step(
        params["decoder"], enc, encp, state.prev_frame, state, jtts, r,
        N_MELS, jax.random.PRNGKey(0), False)
    with torch.no_grad():
        mels_t, scores_t, new_t = taco.decoder_step(
            dec, t_enc_in, t_encp_in, t_state.prev_frame, t_state, r, N_MELS,
            jtts.max_r)
    np.testing.assert_allclose(mels_t.numpy(), np.asarray(mels_j), atol=2e-5)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j),
                               atol=2e-6)
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def _decode_both(kw, r, steps, T_text, seed):
    jtts, params, model = _models(seed, **kw)
    _, (enc, encp), _ = _encode(params, model, T_text, seed)
    mask = jnp.ones((T_text,), jnp.float32)
    mel_k, attn_k, nv_k = decode_pallas(params, enc, encp, mask, jtts, r,
                                        steps, N_MELS, interpret=True)
    # the same encoder outputs feed both decoders: this isolates the decode
    with torch.no_grad():
        mel_t, attn_t, nv_t = cuda_taco.decode(
            model.decoder_weights(), torch.from_numpy(enc),
            torch.from_numpy(encp), torch.ones(T_text), r, steps, N_MELS,
            jtts.max_r, jtts.stop_threshold)
    assert mel_t.shape == (1, N_MELS, steps)
    assert attn_t.shape == (1, steps // r, T_text)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(mel_k), atol=2e-4)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_k), atol=2e-5)
    assert int(nv_t[0]) == int(nv_k[0])
    return mel_t.numpy(), int(nv_t[0])


@pytest.mark.parametrize("r", [2, 5])
def test_decode_plain_matches_decode_pallas_no_stop(r):
    steps = -(-60 // r) * r
    _, nv = _decode_both({}, r, steps, 30, seed=0)
    assert nv == steps // r   # fresh weights never reach the threshold


def test_decode_plain_matches_decode_pallas_forced_stop():
    """stop_threshold=+10 stops at the first group with g*r > 10; the
    frozen-state group then repeats to the end."""
    r, steps = 2, 40
    mel, nv = _decode_both({"stop_threshold": 10.0}, r, steps, 25, seed=1)
    assert nv == 7 < steps // r
    np.testing.assert_array_equal(mel[0, :, -2 * r:-r], mel[0, :, -r:])
    np.testing.assert_array_equal(mel[0, :, nv * r:nv * r + r],
                                  mel[0, :, -r:])


def test_generate_matches_generate_kernel():
    jtts, params, model = _models(2)
    ids = np.random.RandomState(2).randint(1, 148, (35,))
    r, steps = 2, 50
    mel_k, lin_k, attn_k, nv_k = jtaco._generate_kernel(
        params, jnp.asarray(ids)[None], jtts, r, steps, N_MELS,
        jax.random.PRNGKey(0), interpret=True)
    n = int(nv_k[0]) * r
    mel, linear, attn = taco.generate(model, ids, r, steps=steps,
                                      device="cpu")
    assert mel.shape == linear.shape == (N_MELS, n)
    np.testing.assert_allclose(mel, np.asarray(mel_k)[0, :, :n], atol=2e-4)
    np.testing.assert_allclose(linear, np.asarray(lin_k)[0, :, :n],
                               atol=2e-3)
    np.testing.assert_allclose(attn, np.asarray(attn_k)[0, :n // r],
                               atol=2e-5)
