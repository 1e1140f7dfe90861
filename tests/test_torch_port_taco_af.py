"""Port parity: Tacotron attention-forcing training
(``wavernn_tpu_torch.models.tacotron.forward`` in the AF and free-running
modes, ``train.tacotron_train``'s AF losses and steps, kernel B7's plain
versions in ``ops/cuda_taco_train``) against the JAX package on the CPU.

Widths: the JAX B6 tests' (embed 32, encoder 128, decoder 256, postnet 32,
encoder_K 2, lstm 512, postnet_K 2, one highway). Weights: JAX
``init_tacotron`` -> the port's weight bridge. Inputs: numpy from a seed.
Random draws: the JAX forward's key stream, injected into the port (the
encoder prenet's dropout keys from ``k_enc``; the decoder's from
``af_masks(k_dec, ...)``, the scan branch's exact stream). The oracles are
the JAX package's plain references, ``recurrence="scan"`` and
``decoder_af_train(impl="ref")``; its own tests hold its kernels to them
(tests/test_pallas_taco_train.py, tests/test_attention_forcing.py).

Tolerances (float32 on both sides; the differences are summation order):
- the B7 forward, the training forwards (mel, linear, attention) and the
  BatchNorm running statistics: 2e-5 x max(1, |reference|);
- the loss 1e-5 relative and every gradient within 1e-4 of its largest
  entry; the plain hand-written B7 backward against autograd through the
  plain forward, in float64, within 1e-10 of each largest entry.
"""
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.config import TacotronConfig as JTts
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.ops.pallas_taco_train import af_masks as j_af_masks
from wavernn_tpu.ops.pallas_taco_train import decoder_af_train as j_decoder
from wavernn_tpu.paths import Workspace as JWorkspace
from wavernn_tpu.train import checkpoints as jck
from wavernn_tpu.train import tacotron_train as jtt
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu.train.wavernn_train import make_optimizer
from wavernn_tpu_torch.cli import train_tacotron
from wavernn_tpu_torch.compat.from_jax import tacotron_state_dict
from wavernn_tpu_torch.compat.to_jax import tacotron_jax_key
from wavernn_tpu_torch.config import TacotronConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.ops import cuda_taco_train as ct
from wavernn_tpu_torch.train import tacotron_train as tt

N_MELS = 80
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256, postnet_dims=32,
           encoder_K=2, lstm_dims=512, postnet_K=2, num_highways=1)
JT = JTts(**TTS)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


# the step-gradient oracles (JAX ``loss_af`` online and offline, compiled
# whole): their XLA compiles are a third of this file's time, so the
# fixture starts them on a thread and the tests before them overlap it
_ORACLES = {}
GRAD_CASE = (4, 24, 6, 2)      # B, T_text, G, r of the gradient test


def _compile_loss_af_grad(params, offline):
    B, T_text, G, r = GRAD_CASE
    x, m, aref = _batch(B, T_text, G, r, seed=3)
    fn = jax.jit(jax.value_and_grad(jtt.loss_af, has_aux=True),
                 static_argnums=(4, 5, 7, 8, 9, 10))
    return fn.lower(params, jnp.asarray(x), jnp.asarray(m),
                    jnp.asarray(aref), JT, r, jax.random.PRNGKey(9),
                    200.0 if offline else 1.0, offline, None,
                    "scan").compile()


@pytest.fixture(scope="module")
def models():
    # jitted: the same draws as the eager call, in half the time
    params = jax.jit(jtaco.init_tacotron, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), JT, N_MELS)
    model = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    model.load_state_dict(tacotron_state_dict(tree_to_flat(params), -3.4),
                          strict=True)
    pool = ThreadPoolExecutor(1)
    for offline in (False, True):
        _ORACLES[offline] = pool.submit(_compile_loss_af_grad, params,
                                        offline)
    yield params, model
    pool.shutdown(wait=True)


def _fresh(models):
    """The JAX parameters and a copy of the port's model (a training
    forward updates BatchNorm's running statistics in place)."""
    params, model = models
    m2 = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    m2.load_state_dict(model.state_dict())
    return params, m2


def _batch(B, T_text, G, r, seed=0):
    """Text ids, target mels and a reference attention (B, G, T_text)
    whose rows sum to 1."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 148, (B, T_text))
    m = rng.randn(B, N_MELS, G * r).astype(np.float32)
    a = rng.uniform(0.01, 1.0, (B, G, T_text)).astype(np.float32) ** 4
    return x, m, (a / a.sum(-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _jax_masks(key, B, T_text, G):
    """The random draws of the JAX AF / free-running training forward
    under ``key``, as the port's injected masks."""
    k_enc, k_dec, _ = jax.random.split(key, 3)
    keep = 1.0 - JT.dropout
    out = {}
    for name, k, width in zip(("enc_drop1", "enc_drop2"),
                              jax.random.split(k_enc), (256, 128)):
        kept = np.asarray(jax.random.bernoulli(k, keep, (B, T_text, width)))
        out[name] = torch.tensor(kept, dtype=torch.float32) / keep
    dm1, dm2, zm1, zm2 = j_af_masks(k_dec, G, B, JT.lstm_dims, 256, 128,
                                    True, JT.dropout)
    for name, v in zip(("dec_drop1", "dec_drop2", "zm1", "zm2"),
                       (dm1, dm2, zm1, zm2)):
        out[name] = _t(v)
    return out


def _bn_stats(flat):
    return {k: v for k, v in flat.items()
            if k.endswith("/mean") or k.endswith("/var")}


def _ours(model):
    return {tacotron_jax_key(k)[0]: v for k, v in model.state_dict().items()
            if tacotron_jax_key(k) is not None}


# ---------------------------------------------------------------------------
# B7's plain versions: the forward against JAX, the backward against
# autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T_text,G,r,training", [(4, 24, 6, 2, True),
                                                   (5, 33, 7, 2, False)])
def test_b7_plain_forward_matches_jax(models, B, T_text, G, r, training):
    params, model = models
    rng = np.random.RandomState(1)
    enc = rng.randn(B, T_text, 256).astype(np.float32) * 0.5
    encp = rng.randn(B, T_text, 256).astype(np.float32) * 0.5
    _, _, aref = _batch(B, T_text, G, r, seed=2)
    masks = j_af_masks(jax.random.PRNGKey(3), G, B, 512, 256, 128, training)
    mel_j, sc_j = j_decoder(params["decoder"], jnp.asarray(enc),
                            jnp.asarray(encp), jnp.asarray(aref), *masks,
                            20, r, N_MELS, impl="ref")
    with torch.no_grad():
        mel, sc = ct.decoder_af_train(model.decoder_parameters(), _t(enc),
                                      _t(encp), _t(aref),
                                      *(_t(v) for v in masks), 20, r, N_MELS)
    _close(mel, mel_j, 2e-5)
    _close(sc, sc_j, 2e-5)


def test_b7_plain_backward_matches_autograd(models):
    """The hand-written reverse sweep (the CUDA backward's spec) against
    autograd through the plain forward, in float64, with nonzero mel and
    scores cotangents: d(aref), d(enc), d(encp), the prenet's and every
    other weight gradient."""
    dec = {k: v.double() for k, v in models[1].decoder_parameters().items()}
    B, T_text, G, r = 3, 20, 5, 2
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64
    enc = (torch.randn(B, T_text, 256, generator=g, dtype=f64)
           * 0.5).requires_grad_()
    encp = (torch.randn(B, T_text, 256, generator=g, dtype=f64)
            * 0.5).requires_grad_()
    aref = torch.rand(G, B, T_text, generator=g, dtype=f64).requires_grad_()
    dm1 = (torch.rand(G, B, 256, generator=g) < 0.5).double() * 2.0
    dm2 = (torch.rand(G, B, 128, generator=g) < 0.5).double() * 2.0
    zm1, zm2 = (torch.rand(2, G, B, 512, generator=g) < 0.1).double()
    weights = [w.detach().requires_grad_()
               for w in ct.af_operands(dec, 20, r, N_MELS)]
    mel, sc, streams = ct.core_af_ref(aref, dm1, dm2, zm1, zm2, enc, encp,
                                      *weights, save=True)
    dmel = torch.randn(mel.shape, generator=g, dtype=f64)
    dsc = torch.randn(sc.shape, generator=g, dtype=f64)
    want = torch.autograd.grad((mel * dmel).sum() + (sc * dsc).sum(),
                               [aref, enc, encp] + weights)
    got = ct.core_af_bwd_ref(dmel, dsc, {k: v.detach() for k, v in
                                         streams.items()}, sc.detach(),
                             aref.detach(), dm1, dm2, zm1, zm2, enc.detach(),
                             encp.detach(), *[w.detach() for w in weights])
    names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS
    assert len(got) == len(names) == len(want)
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-10, (name, err)


# ---------------------------------------------------------------------------
# the training forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["attention_forcing_online",
                                  "free_running"])
def test_training_forward_matches_jax(models, mode):
    params, model = _fresh(models)
    B, T_text, G, r = 4, 24, 6, 2
    x, m, aref = _batch(B, T_text, G, r)
    key = jax.random.PRNGKey(7)
    af = mode != "free_running"
    mel_j, lin_j, att_j, new_p = jtaco.forward(
        params, jnp.asarray(x), jnp.asarray(m), JT, r, key, mode=mode,
        training=True, attn_ref=jnp.asarray(aref) if af else None,
        recurrence="scan")
    masks = _jax_masks(key, B, T_text, G)
    with torch.no_grad():
        mel, lin, att = taco.forward(model, torch.tensor(x), torch.tensor(m),
                                     r, mode=mode, masks=masks,
                                     attn_ref=_t(aref) if af else None)
    _close(mel, mel_j, 2e-5)
    _close(lin, lin_j, 2e-5)
    _close(att, att_j, 2e-5)
    ours = _ours(model)
    for k, v in _bn_stats(tree_to_flat(new_p)).items():
        _close(ours[k], v, 2e-5)


# ---------------------------------------------------------------------------
# the CLI: TF, the attention export, AF-online and AF-offline (torch only;
# the gradient oracles' compiles have had the JAX tests above to overlap)
# ---------------------------------------------------------------------------

SENTENCES = ["The birch canoe slid on the smooth planks.",
             "Glue the sheet to the dark blue background."]


def _tts_dataset(root, n_items=8, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"item{i:03d}"
        frames = int(rng.randint(6, 14))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (N_MELS, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = SENTENCES[i % 2][:12 + 3 * (i % 5)]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def _hparams(tmp_path, name, model_id, *extra):
    hp = tmp_path / name
    lines = [f"data_path = {str(tmp_path / 'data')!r}",
             f"tts_model_id = {model_id!r}",
             "tts_schedule = [(2, 1e-3, 2, 4)]",
             "tts_checkpoint_every = 1000", *extra]
    lines += [f"tts_{k} = {v!r}" for k, v in TTS.items()]
    hp.write_text("\n".join(lines) + "\n")
    return hp


def test_cli_trains_af_online_and_offline(models, tmp_path, monkeypatch):
    import json
    _tts_dataset(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    hp_tf = _hparams(tmp_path, "tf.py", "tiny")
    train_tacotron.main(["--hp_file", str(hp_tf), "--force_cpu"])
    train_tacotron.main(["--hp_file", str(hp_tf), "--force_cpu",
                         "--force_attn"])
    attn = sorted((tmp_path / "data" / "attn_tiny").iterdir())
    assert len(attn) == 8
    tf_ckpt = str(tmp_path / "checkpoints" / "tiny.tacotron"
                  / "latest_weights.npz")
    runs = {"af_on": ("mode = 'attention_forcing_online'",
                      f"model_tf_path = {tf_ckpt!r}"),
            "af_off": ("mode = 'attention_forcing_offline'",
                       "attn_loss_coeff = 200.0",
                       "attn_ref_path = 'attn_tiny'")}
    for model_id, extra in runs.items():
        hp = _hparams(tmp_path, f"{model_id}.py", model_id, *extra,
                      f"tts_init_weights_path = {tf_ckpt!r}")
        train_tacotron.main(["--hp_file", str(hp), "--force_cpu"])
        ckpt = tmp_path / "checkpoints" / f"{model_id}.tacotron"
        for f in ("latest_weights.npz", "latest_optim.npz"):
            assert (ckpt / f).exists(), (model_id, f)
        records = [json.loads(ln) for ln in
                   (ckpt / "metrics.jsonl").read_text().splitlines()]
        sessions = [r for r in records if r["event"] == "session"]
        assert [r["step"] for r in sessions] == [2]
        assert np.isfinite(sessions[0]["loss"])
        assert sessions[0]["nonfinite_grad_steps"] == 0
        with np.load(ckpt / "latest_weights.npz") as z:
            assert int(z["meta/step"]) == 2 and int(z["meta/r"]) == 2

    # the JAX package restores the AF student's pair
    jcfg = JConfig.from_hparams_file(tmp_path / "af_off.py")
    jws = JWorkspace(jcfg.data_path, jcfg.voc_model_id, jcfg.tts_model_id,
                     output_root=tmp_path)
    params = models[0]
    _, _, step = jck.restore_checkpoint(
        "tts", jws, params, make_optimizer(1e-3, 1.0).init(params))
    assert step == 2


# ---------------------------------------------------------------------------
# one step's loss and gradients, the KL loss and the teacher's attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offline,coeff", [(False, 1.0), (True, 200.0)])
def test_af_step_gradients_match_jax(models, offline, coeff):
    params, model = _fresh(models)
    B, T_text, G, r = GRAD_CASE
    x, m, aref = _batch(B, T_text, G, r, seed=3)
    key = jax.random.PRNGKey(9)
    (loss_j, (_, _, lout_j, latt_j)), grads_j = _ORACLES[offline].result()(
        params, jnp.asarray(x), jnp.asarray(m), jnp.asarray(aref), key)
    masks = _jax_masks(key, B, T_text, G)
    loss, _, l_out, l_attn, grads = tt.loss_and_grads_af(
        model, torch.tensor(x), torch.tensor(m), _t(aref), r, coeff, offline,
        masks=masks)
    for got, want in ((loss, loss_j), (l_out, lout_j), (l_attn, latt_j)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    flat_j = tree_to_flat(grads_j)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(flat_j) - len(_bn_stats(flat_j))
    for name, g in zip(names, grads):
        key_j, transpose = tacotron_jax_key(name)
        want = flat_j[key_j].T if transpose else flat_j[key_j]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)


def test_attention_kl_and_teacher_attn_ref_match_jax(models):
    params, model = _fresh(models)
    B, T_text, G, r = 4, 24, 6, 2
    x, m, aref = _batch(B, T_text, G, r, seed=4)
    rng = np.random.RandomState(5)
    student = rng.uniform(0, 1, aref.shape).astype(np.float32)
    student[0, 0, :3] = 0.0                      # the eps clamp
    _close(tt.attention_kl(_t(student), _t(aref)),
           jtt.attention_kl(jnp.asarray(student), jnp.asarray(aref)), 1e-6)
    want = jtt.teacher_attn_ref(params, jnp.asarray(x), jnp.asarray(m), JT,
                                r, jax.random.PRNGKey(1), recurrence="scan")
    got = tt.teacher_attn_ref(model, torch.tensor(x), torch.tensor(m), r)
    assert not got.requires_grad
    _close(got, want, 2e-5)
