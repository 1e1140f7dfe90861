"""Port parity: Tacotron teacher-forcing training
(``wavernn_tpu_torch.models.tacotron.forward``, ``train.tacotron_train``,
kernel B6's plain versions in ``ops/cuda_taco_train``) against the JAX
package on the CPU.

Widths: the JAX B6 tests' (embed 32, encoder 128, decoder 256, postnet 32,
encoder_K 2, lstm 512, postnet_K 2, one highway). Weights: JAX
``init_tacotron`` -> the port's weight bridge. Inputs: numpy from a seed.
Random draws: the JAX forward's key stream (the encoder's and the
decoder's prenet dropout keys, ``zoneout_masks``), injected into the port.
The oracles are the JAX package's plain references, ``recurrence="scan"``
and ``decoder_tf_train(impl="ref")``; its own tests hold its kernels to
them (tests/test_pallas_taco_train.py).

Tolerances (float32 on both sides; the differences are summation order):
- the B6 forward, the training forward (mel, linear, attention) and the
  BatchNorm running statistics: 2e-5 x max(1, |reference|);
- the loss 1e-5 relative and every gradient within 1e-4 of its largest
  entry; the plain hand-written B6 backward against autograd through the
  plain forward, in float64, within 1e-10 of each largest entry;
- the GTA mels and attention maps: 2e-5 x max(1, |reference|);
- the collate and batch order exactly; checkpoints bit for bit.
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.config import TacotronConfig as JTts
from wavernn_tpu.config import TacotronTrainConfig as JTrain
from wavernn_tpu.data.dataset import get_tts_datasets as j_datasets
from wavernn_tpu.models import tacotron as jtaco
from wavernn_tpu.ops.pallas_taco_train import decoder_tf_train as j_decoder
from wavernn_tpu.ops.pallas_taco_train import zoneout_masks as j_zoneout
from wavernn_tpu.paths import Workspace as JWorkspace
from wavernn_tpu.train import checkpoints as jck
from wavernn_tpu.train import tacotron_train as jtt
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.cli import train_tacotron
from wavernn_tpu_torch.compat.from_jax import tacotron_state_dict
from wavernn_tpu_torch.compat.to_jax import tacotron_jax_key
from wavernn_tpu_torch.config import Config, TacotronConfig, TacotronTrainConfig
from wavernn_tpu_torch.data.dataset import get_tts_datasets
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.ops import cuda_taco_train as ct
from wavernn_tpu_torch.paths import Workspace
from wavernn_tpu_torch.train import checkpoints as ck
from wavernn_tpu_torch.train import tacotron_train as tt

N_MELS = 80
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256, postnet_dims=32,
           encoder_K=2, lstm_dims=512, postnet_K=2, num_highways=1)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


def _models(seed=0):
    params = jtaco.init_tacotron(jax.random.PRNGKey(seed), JTts(**TTS),
                                 N_MELS)
    model = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    model.load_state_dict(tacotron_state_dict(tree_to_flat(params), -3.4),
                          strict=True)
    return params, model


def _batch(B, T_text, G, r, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 148, (B, T_text))
    m = rng.randn(B, N_MELS, G * r).astype(np.float32)
    return x, m


def _jax_masks(key, B, T_text, G, tts):
    """The random draws of the JAX TF training forward under ``key``,
    as the port's injected masks."""
    k_enc, k_dec, k_pre = jax.random.split(key, 3)
    keep = 1.0 - tts.dropout
    out = {}
    for (k1, k2), pre, rows in ((jax.random.split(k_enc), "enc",
                                 (B, T_text)),
                                (jax.random.split(k_pre), "dec", (G * B,))):
        for name, k, width in (("drop1", k1, 256), ("drop2", k2, 128)):
            kept = np.asarray(jax.random.bernoulli(k, keep, rows + (width,)))
            out[f"{pre}_{name}"] = torch.tensor(kept, dtype=torch.float32) \
                / keep
    for name in ("dec_drop1", "dec_drop2"):
        out[name] = out[name].reshape(G, B, -1)
    zm1, zm2 = j_zoneout(k_dec, G, B, tts.lstm_dims)
    out["zm1"] = torch.tensor(np.asarray(zm1), dtype=torch.float32)
    out["zm2"] = torch.tensor(np.asarray(zm2), dtype=torch.float32)
    return out


# ---------------------------------------------------------------------------
# (a) B6's plain forward against the JAX package's reference twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T_text,G,r", [(4, 24, 5, 2), (4, 24, 4, 5),
                                          (5, 33, 7, 2)])
def test_b6_plain_forward_matches_jax(B, T_text, G, r):
    params, model = _models()
    rng = np.random.RandomState(1)
    enc = rng.randn(B, T_text, 256).astype(np.float32) * 0.5
    encp = rng.randn(B, T_text, 256).astype(np.float32) * 0.5
    pre = np.abs(rng.randn(G, B, 128)).astype(np.float32)
    zm1, zm2 = j_zoneout(jax.random.PRNGKey(3), G, B, 512)
    mel_j, sc_j = j_decoder(params["decoder"], jnp.asarray(enc),
                            jnp.asarray(encp), jnp.asarray(pre), zm1, zm2,
                            20, r, N_MELS, impl="ref")
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    with torch.no_grad():
        mel, sc = ct.decoder_tf_train(model.decoder_parameters(), t(enc),
                                      t(encp), t(pre), t(zm1), t(zm2), 20, r,
                                      N_MELS)
    _close(mel, mel_j, 2e-5)
    _close(sc, sc_j, 2e-5)


# ---------------------------------------------------------------------------
# (b) the training forward, (c) one step's loss and gradients
# ---------------------------------------------------------------------------

def _bn_stats(flat):
    return {k: v for k, v in flat.items()
            if k.endswith("/mean") or k.endswith("/var")}


@pytest.mark.parametrize("r", [2, 5])
def test_training_forward_matches_jax(r):
    params, model = _models()
    B, T_text, G = 4, 24, 6
    x, m = _batch(B, T_text, G, r)
    key = jax.random.PRNGKey(7)
    mel_j, lin_j, att_j, new_p = jtaco.forward(
        params, jnp.asarray(x), jnp.asarray(m), JTts(**TTS), r, key,
        mode="teacher_forcing", training=True, recurrence="scan")
    masks = _jax_masks(key, B, T_text, G, JTts(**TTS))
    with torch.no_grad():
        mel, lin, att = taco.forward(model, torch.tensor(x), torch.tensor(m),
                                     r, masks=masks)
    _close(mel, mel_j, 2e-5)
    _close(lin, lin_j, 2e-5)
    _close(att, att_j, 2e-5)
    ours = {tacotron_jax_key(k)[0]: v for k, v in model.state_dict().items()
            if tacotron_jax_key(k) is not None}
    for k, v in _bn_stats(tree_to_flat(new_p)).items():
        _close(ours[k], v, 2e-5)


def test_training_step_gradients_match_jax():
    params, model = _models()
    B, T_text, G, r = 4, 24, 6, 2
    x, m = _batch(B, T_text, G, r, seed=2)
    key = jax.random.PRNGKey(9)
    (loss_j, _), grads_j = jax.value_and_grad(jtt.loss_tf, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(m), JTts(**TTS), r, key, None,
        "scan")
    masks = _jax_masks(key, B, T_text, G, JTts(**TTS))
    loss, _, grads = tt.loss_and_grads(model, torch.tensor(x),
                                       torch.tensor(m), r, masks=masks)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    flat_j = tree_to_flat(grads_j)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(flat_j) - len(_bn_stats(flat_j))
    for name, g in zip(names, grads):
        key_j, transpose = tacotron_jax_key(name)
        want = flat_j[key_j].T if transpose else flat_j[key_j]
        got = g.numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, (name, err)


def test_b6_plain_backward_matches_autograd():
    """The hand-written reverse sweep (the CUDA backward's spec) against
    autograd through the plain forward, in float64 with nonzero scores
    cotangents."""
    _, model = _models()
    dec = {k: v.double() for k, v in model.decoder_parameters().items()}
    B, T_text, G, r = 3, 20, 5, 2
    g = torch.Generator().manual_seed(0)
    enc = (torch.randn(B, T_text, 256, generator=g, dtype=torch.float64)
           * 0.5).requires_grad_()
    encp = (torch.randn(B, T_text, 256, generator=g, dtype=torch.float64)
            * 0.5).requires_grad_()
    pre = torch.rand(G, B, 128, generator=g,
                     dtype=torch.float64).requires_grad_()
    zm1, zm2 = (torch.rand(2, G, B, 512, generator=g) < 0.1).double()
    weights = [w.detach().requires_grad_()
               for w in ct.decoder_operands(dec, 20, r, N_MELS)]
    mel, sc, streams = ct.core_ref(pre, zm1, zm2, enc, encp, *weights,
                                   save=True)
    dmel = torch.randn(mel.shape, generator=g, dtype=torch.float64)
    dsc = torch.randn(sc.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad((mel * dmel).sum() + (sc * dsc).sum(),
                               [pre, enc, encp] + weights)
    got = ct.core_bwd_ref(dmel, dsc, {k: v.detach() for k, v in
                                      streams.items()}, sc.detach(),
                          pre.detach(), zm1, zm2, enc.detach(),
                          encp.detach(), *[w.detach() for w in weights])
    names = ("dpre", "denc", "dencp") + ct.WEIGHTS
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-10, (name, err)


# ---------------------------------------------------------------------------
# data: (e) collate and batch order, (d) GTA / attention export
# ---------------------------------------------------------------------------

SENTENCES = ["The birch canoe slid on the smooth planks.",
             "Glue the sheet to the dark blue background.",
             "It's easy to tell the depth of a well.",
             "These days a chicken leg is a rare dish."]


def _tts_dataset(root, n_items=16, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"item{i:03d}"
        frames = int(rng.randint(12, 30))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (N_MELS, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = SENTENCES[i % len(SENTENCES)][:10 + 3 * (i % 7)]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def _cfgs(**train):
    return (JConfig(tts=JTts(**TTS), tts_train=JTrain(**train)),
            Config(tts=TacotronConfig(**TTS),
                   tts_train=TacotronTrainConfig(**train)))


def test_tts_batches_match_jax(tmp_path):
    _tts_dataset(tmp_path)
    jcfg, cfg = _cfgs(max_mel_len=26)
    jb, jex = j_datasets(tmp_path, 3, 5, jcfg, seed=3)
    pb, pex = get_tts_datasets(tmp_path, 3, 5, cfg, seed=3)
    assert pex == jex and len(pb) == len(jb)
    for _ in range(2):                       # two epochs, two orders
        for jbatch, pbatch in zip(jb, pb):
            for a, b in zip(jbatch, pbatch):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert list(a) == list(b)


def test_gta_and_attention_export_match_jax(tmp_path):
    _tts_dataset(tmp_path / "data", n_items=8)
    params, model = _models(seed=4)
    jcfg, cfg = _cfgs()
    r = 2
    jds, _ = j_datasets(tmp_path / "data", 4, r, jcfg, seed=1)
    jtt.create_gta_features(params, jds, JTts(**TTS), r, tmp_path / "jgta",
                            log=lambda *a: None)
    jtt.create_attn_ref(params, jds, JTts(**TTS), r, tmp_path / "jattn",
                        log=lambda *a: None)
    ds, _ = get_tts_datasets(tmp_path / "data", 4, r, cfg, seed=1)
    tt.create_gta_features(model, ds, r, tmp_path / "gta",
                           log=lambda *a: None)
    tt.create_attn_ref(model, ds, r, tmp_path / "attn", log=lambda *a: None)
    for sub in ("gta", "attn"):
        files = sorted(p.name for p in (tmp_path / sub).iterdir())
        assert files == sorted(p.name for p in (tmp_path / f"j{sub}").iterdir())
        assert len(files) == 8
        for name in files:
            _close(np.load(tmp_path / sub / name),
                   np.load(tmp_path / f"j{sub}" / name), 2e-5)


# ---------------------------------------------------------------------------
# (f) the CLI end to end, and checkpoints both ways
# ---------------------------------------------------------------------------

def _hparams(tmp_path):
    hp = tmp_path / "hp.py"
    lines = [f"data_path = {str(tmp_path / 'data')!r}",
             "tts_model_id = 'tiny'",
             "tts_schedule = [(2, 1e-3, 2, 4), (5, 1e-4, 3, 4)]",
             "tts_checkpoint_every = 2"]
    lines += [f"tts_{k} = {v!r}" for k, v in TTS.items()]
    hp.write_text("\n".join(lines) + "\n")
    return hp


def test_cli_trains_across_r_and_checkpoints_interoperate(tmp_path,
                                                          monkeypatch):
    _tts_dataset(tmp_path / "data", n_items=8)
    hp = _hparams(tmp_path)
    monkeypatch.chdir(tmp_path)
    train_tacotron.main(["--hp_file", str(hp), "--force_cpu"])
    ckpt = tmp_path / "checkpoints" / "tiny.tacotron"
    for f in ("latest_weights.npz", "latest_optim.npz",
              "taco_step0K_weights.npz", "taco_step0K_optim.npz",
              "log.txt", "metrics.jsonl"):
        assert (ckpt / f).exists(), f
    sessions = [ln for ln in (ckpt / "log.txt").read_text().splitlines()]
    assert len(sessions) == 2
    with np.load(ckpt / "latest_weights.npz") as z:
        assert int(z["meta/step"]) == 3 and int(z["meta/r"]) == 5

    # the JAX package restores the port's pair
    jcfg = JConfig.from_hparams_file(hp)
    jws = JWorkspace(jcfg.data_path, jcfg.voc_model_id, jcfg.tts_model_id,
                     output_root=tmp_path)
    jstate = jtt.create_train_state(jax.random.PRNGKey(5), jcfg.tts, N_MELS,
                                    1e-4, 1.0)
    jp, jo, step = jck.restore_checkpoint("tts", jws, jstate.params,
                                          jstate.opt_state)
    assert step == 3
    cfg = Config.from_hparams_file(hp)
    ws = Workspace(cfg.data_path, cfg.voc_model_id, cfg.tts_model_id,
                   output_root=tmp_path)
    state = tt.create_train_state(cfg.tts, N_MELS, 1e-4, 1.0, seed=9,
                                  device="cpu")
    assert ck.restore_checkpoint("tts", ws, state.model, state.opt) == 3
    assert int(state.model.decoder.r) == 5
    ours = ck.optimizer_flat(state.model, state.opt)
    theirs = tree_to_flat({"opt": jo})
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v)

    # the port resumes the JAX package's pair
    jck.save_checkpoint("tts", jws, jstate.params, jstate.opt_state, 7,
                        extra_meta={"r": 2}, log=lambda *a: None)
    assert ck.restore_checkpoint("tts", ws, state.model, state.opt) == 7
    assert int(state.model.decoder.r) == 2
    flat = tree_to_flat(jstate.params)
    for name, t in state.model.state_dict().items():
        hit = tacotron_jax_key(name)
        if hit is not None:
            want = flat[hit[0]].T if hit[1] else flat[hit[0]]
            np.testing.assert_array_equal(t.numpy(), want)

    # --force_gta from that checkpoint: one file per item
    train_tacotron.main(["--hp_file", str(hp), "--force_cpu", "--force_gta"])
    gta = sorted((tmp_path / "data" / "gta_tiny").iterdir())
    assert len(gta) == 8
    for p in gta:
        a = np.load(p)
        mel_len = np.load(tmp_path / "data" / "mel" / p.name).shape[1]
        assert a.shape == (N_MELS, mel_len) and np.isfinite(a).all()


def test_cli_raises_for_unported_options(tmp_path, monkeypatch):
    hp = _hparams(tmp_path)
    monkeypatch.chdir(tmp_path)
    # bfloat16 training is ported: the setting constructs; an unknown
    # precision still raises
    assert TacotronTrainConfig(precision="bfloat16").precision == "bfloat16"
    with pytest.raises(ValueError, match="precision"):
        TacotronTrainConfig(precision="float16")
    with open(hp, "a") as f:
        f.write("mode = 'attention_forcing'\n")
    with pytest.raises(ValueError, match="mode"):
        train_tacotron.main(["--hp_file", str(hp), "--force_cpu"])
    x, m = _batch(2, 8, 3, 2)
    with pytest.raises(ValueError, match="mode"):
        taco.forward(_models()[1], torch.tensor(x), torch.tensor(m), 2,
                     mode="forcing")
