"""Port parity: bfloat16 Tacotron training (``tts_precision =
'bfloat16'``): kernels B6 and B7's bf16 plain versions
(``ops/cuda_taco_train``), the model's ``compute_dtype``, the trainer's
``precision``, the CLI and a data-parallel step, against the JAX package
on the CPU.

Widths: the JAX B6 tests' (embed 32, encoder 128, decoder 256, postnet 32,
encoder_K 2, lstm 512, postnet_K 2, one highway), a few groups. Weights:
JAX ``init_tacotron`` -> the port's weight bridge, cast to bfloat16 on
both sides (BatchNorm's stay float32). Inputs: numpy from a seed; the JAX
forward's key stream injected as the port's masks.

Tolerances, each over the reference's largest magnitude (bfloat16 keeps 8
bits, 2^-9 = 2e-3 relative a rounding; the rest is where the two sides
round differently and how the flips compound over the groups):
- the B6 / B7 bf16 forwards against ``decoder_*_train(impl="ref")`` (the
  JAX kernels' flat twins, the same rounding points): mel and scores 1e-2;
- their bf16 backwards against ``jax.vjp`` of ``impl="pallas_interpret"``
  (the JAX kernel, which also rounds each cotangent to bfloat16 before its
  product; the port keeps them float32, module docstring of
  ``ops/cuda_taco_train``): every weight and input cotangent 2e-2;
- the bf16 training losses against ``loss_tf`` / ``loss_af``
  (``compute_dtype=bfloat16, recurrence="pallas_interpret"``): 2e-2
  relative, the chip's kernels-vs-scan rule;
- the bf16 gradient against the float32 one from the same weights, batch
  and masks: cosine above 0.97 over all parameters
  (tests/test_train.py's rule); 25 bf16 steps lower the loss;
- two gloo ranks against one process for one bf16 TF step: loss and grad
  norm 1e-3 relative, the parameters after it within 2 lr of each other
  (Adam moves a weight whose gradient's sign flips on a rounding by about
  2 lr).
"""
import argparse
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from wavernn_tpu_torch.config import TacotronConfig  # noqa: E402

N_MELS = 80
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256, postnet_dims=32,
           encoder_K=2, lstm_dims=512, postnet_K=2, num_highways=1)
BF = torch.bfloat16
WORLD, DP_B, DP_TEXT, DP_G, DP_R, DP_LR = 2, 4, 10, 3, 2, 1e-3
TIMEOUT_S = 240


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(torch.as_tensor(want).float(), np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tiny_model(seed=0):
    from wavernn_tpu_torch.models import tacotron as taco
    model = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _dp_batch():
    rng = np.random.RandomState(11)
    x = rng.randint(1, 148, (DP_B, DP_TEXT))
    m = rng.randn(DP_B, N_MELS, DP_G * DP_R).astype(np.float32)
    return torch.tensor(x), torch.tensor(m)


def _dp_masks():
    from wavernn_tpu_torch.models import tacotron as taco
    return taco.draw_masks(_tiny_model(), DP_B, DP_TEXT, DP_G,
                           torch.Generator().manual_seed(5), "cpu")


def _dp_step(mesh, rows):
    """One bf16 TF step of the seeded tiny model on ``rows`` of the batch
    (this rank's shard on a mesh): (loss, grad norm, parameters)."""
    from wavernn_tpu_torch.train import tacotron_train as tt
    from wavernn_tpu_torch.train.wavernn_train import make_optimizer
    model = _tiny_model()
    state = tt.TTSTrainState(model, make_optimizer(model, DP_LR, 1.0), 0)
    x, m = _dp_batch()
    masks = {k: (v[rows] if k.startswith("enc") else v[:, rows]).contiguous()
             for k, v in _dp_masks().items()}
    out = tt.train_step_tf(state, x[rows], m[rows], DP_R, masks=masks,
                           mesh=mesh, precision="bfloat16")
    return (float(out["loss"]), float(out["grad_norm"]),
            {k: v.detach().clone() for k, v in model.named_parameters()})


def worker(rank: int, world: int, out: Path) -> None:
    """One gloo rank of the data-parallel bf16 step."""
    torch.set_num_threads(1)
    from wavernn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh)
    initialize_distributed("cpu")
    mesh = make_mesh()
    per = DP_B // world
    res = _dp_step(mesh, slice(rank * per, (rank + 1) * per))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    a = ap.parse_args()
    worker(a.rank, a.world, Path(a.dir))
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wavernn_tpu.config import TacotronConfig as JTts  # noqa: E402
from wavernn_tpu.models import tacotron as jtaco  # noqa: E402
from wavernn_tpu.ops.pallas_taco_train import af_masks as j_af_masks  # noqa: E402
from wavernn_tpu.ops.pallas_taco_train import decoder_af_train as j_af  # noqa: E402
from wavernn_tpu.ops.pallas_taco_train import decoder_tf_train as j_tf  # noqa: E402
from wavernn_tpu.ops.pallas_taco_train import zoneout_masks as j_zoneout  # noqa: E402
from wavernn_tpu.train import tacotron_train as jtt  # noqa: E402
from wavernn_tpu.train.checkpoints import tree_to_flat  # noqa: E402
from wavernn_tpu_torch.cli import train_tacotron  # noqa: E402
from wavernn_tpu_torch.compat.from_jax import tacotron_state_dict  # noqa: E402
from wavernn_tpu_torch.compat.to_jax import tacotron_jax_key  # noqa: E402
from wavernn_tpu_torch.config import TacotronTrainConfig  # noqa: E402
from wavernn_tpu_torch.models import tacotron as taco  # noqa: E402
from wavernn_tpu_torch.ops import cuda_taco_train as ct  # noqa: E402
from wavernn_tpu_torch.train import checkpoints as ck  # noqa: E402
from wavernn_tpu_torch.train import tacotron_train as tt  # noqa: E402
from wavernn_tpu_torch.train.wavernn_train import make_optimizer  # noqa: E402

JT = JTts(**TTS)
JBF = jnp.bfloat16


@pytest.fixture(scope="module")
def models():
    params = jtaco.init_tacotron(jax.random.PRNGKey(0), JT, N_MELS)
    model = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    model.load_state_dict(tacotron_state_dict(tree_to_flat(params), -3.4),
                          strict=True)
    return params, model


def _fresh(models):
    params, model = models
    m2 = taco.Tacotron(TacotronConfig(**TTS), N_MELS)
    m2.load_state_dict(model.state_dict())
    return params, m2


def _t(a):
    """numpy or JAX (any dtype) -> float32 torch."""
    return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32)))


def _dec_bf16(model):
    return {k: v.detach().to(BF) for k, v in model.decoder_parameters().items()}


def _planes(B, T, G, seed=1):
    rng = np.random.RandomState(seed)
    enc = jnp.asarray(rng.randn(B, T, 256).astype(np.float32) * 0.5).astype(JBF)
    encp = jnp.asarray(rng.randn(B, T, 256).astype(np.float32) * 0.5).astype(JBF)
    pre = jnp.asarray(np.abs(rng.randn(G, B, 128)).astype(np.float32)).astype(JBF)
    a = rng.uniform(0.01, 1.0, (B, G, T)).astype(np.float32) ** 4
    aref = jnp.asarray(a / a.sum(-1, keepdims=True)).astype(JBF)
    return enc, encp, pre, aref


def _jax_masks(key, B, T_text, G, af):
    """The JAX training forward's random draws under ``key`` as the port's
    injected masks (the TF hoisted prenet's or the AF recurrence's)."""
    k_enc, k_dec, k_pre = jax.random.split(key, 3)
    keep = 1.0 - JT.dropout
    out = {}
    for name, k, width in zip(("enc_drop1", "enc_drop2"),
                              jax.random.split(k_enc), (256, 128)):
        kept = np.asarray(jax.random.bernoulli(k, keep, (B, T_text, width)))
        out[name] = torch.tensor(kept, dtype=torch.float32) / keep
    if af:
        vals = j_af_masks(k_dec, G, B, JT.lstm_dims, 256, 128, True,
                          JT.dropout)
        out.update(zip(("dec_drop1", "dec_drop2", "zm1", "zm2"),
                       (_t(v) for v in vals)))
        return out
    for name, k, width in zip(("dec_drop1", "dec_drop2"),
                              jax.random.split(k_pre), (256, 128)):
        kept = np.asarray(jax.random.bernoulli(k, keep, (G * B, width)))
        out[name] = (torch.tensor(kept, dtype=torch.float32)
                     / keep).reshape(G, B, width)
    zm1, zm2 = j_zoneout(k_dec, G, B, JT.lstm_dims)
    out["zm1"], out["zm2"] = _t(zm1), _t(zm2)
    return out


# ---------------------------------------------------------------------------
# B6 and B7's bf16 plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,G,r", [(4, 24, 5, 2), (5, 33, 4, 5)])
def test_b6_bf16_plain_forward_matches_jax_ref(models, B, T, G, r):
    params, model = models
    pb = jtaco._cast_params_except_bn(params, JBF)
    enc, encp, pre, _ = _planes(B, T, G)
    zm1, zm2 = j_zoneout(jax.random.PRNGKey(3), G, B, 512)
    mel_j, sc_j = j_tf(pb["decoder"], enc, encp, pre, zm1, zm2, 20, r,
                       N_MELS, impl="ref")
    with torch.no_grad():
        mel, sc = ct.decoder_tf_train(_dec_bf16(model), _t(enc).to(BF),
                                      _t(encp).to(BF), _t(pre).to(BF),
                                      _t(zm1), _t(zm2), 20, r, N_MELS)
    assert mel.dtype == BF and sc.dtype == torch.float32
    assert _rel(mel, _t(mel_j)) <= 1e-2
    assert _rel(sc, _t(sc_j)) <= 1e-2


@pytest.mark.parametrize("training", [True, False])
def test_b7_bf16_plain_forward_matches_jax_ref(models, training):
    params, model = models
    pb = jtaco._cast_params_except_bn(params, JBF)
    B, T, G, r = 4, 24, 5, 2
    enc, encp, _, aref = _planes(B, T, G)
    masks = j_af_masks(jax.random.PRNGKey(3), G, B, 512, 256, 128, training)
    mel_j, sc_j = j_af(pb["decoder"], enc, encp, aref, *masks, 20, r, N_MELS,
                       impl="ref")
    with torch.no_grad():
        mel, sc = ct.decoder_af_train(_dec_bf16(model), _t(enc).to(BF),
                                      _t(encp).to(BF), _t(aref).to(BF),
                                      *(_t(v) for v in masks), 20, r, N_MELS)
    assert mel.dtype == BF
    assert _rel(mel, _t(mel_j)) <= 1e-2
    assert _rel(sc, _t(sc_j)) <= 1e-2


def _vjp_case(models, af):
    """(the port's gradients, the JAX kernel's cotangents) by name, for one
    bf16 decoder call of each side under the same cotangents."""
    params, model = models
    pb = jtaco._cast_params_except_bn(params, JBF)
    B, T, G, r = 3, 20, 4, 2
    enc, encp, pre, aref = _planes(B, T, G, seed=2)
    if af:
        masks = j_af_masks(jax.random.PRNGKey(4), G, B, 512, 256, 128, True)
        fn = lambda d, e, ep, a: j_af(d, e, ep, a, *masks, 20, r, N_MELS,
                                      impl="pallas_interpret")
        first = aref
    else:
        zm1, zm2 = j_zoneout(jax.random.PRNGKey(4), G, B, 512)
        fn = lambda d, e, ep, p: j_tf(d, e, ep, p, zm1, zm2, 20, r, N_MELS,
                                      impl="pallas_interpret")
        first = pre
    (mel_j, sc_j), vjp = jax.vjp(fn, pb["decoder"], enc, encp, first)
    rng = np.random.RandomState(5)
    dmel = jnp.asarray(rng.randn(*mel_j.shape).astype(np.float32)).astype(JBF)
    dsc = jnp.asarray(rng.randn(*sc_j.shape).astype(np.float32)).astype(JBF)
    cj = vjp((dmel, dsc))
    dec = {k: v.clone().requires_grad_() for k, v in _dec_bf16(model).items()}
    ins = [_t(a).to(BF).requires_grad_() for a in (enc, encp, first)]
    if af:
        mel, sc = ct.decoder_af_train(dec, ins[0], ins[1], ins[2],
                                      *(_t(v) for v in masks), 20, r, N_MELS)
    else:
        mel, sc = ct.decoder_tf_train(dec, ins[0], ins[1], ins[2], _t(zm1),
                                      _t(zm2), 20, r, N_MELS)
    loss = (mel.float() * _t(dmel)).sum() + (sc.float() * _t(dsc)).sum()
    grads = torch.autograd.grad(loss, list(dec.values()) + ins,
                                allow_unused=True)
    flat = tree_to_flat({"decoder": cj[0]})
    got, want = {}, {}
    for (k, _), g in zip(dec.items(), grads):
        if g is None:           # TF: the prenet runs outside the recurrence
            assert not af and k.startswith("prenet.")
            continue
        key, transpose = tacotron_jax_key("decoder." + k)
        w = np.asarray(jnp.asarray(flat[key]).astype(jnp.float32))
        got[k], want[k] = g.float(), torch.tensor(w.T if transpose else w)
    for name, g, w in zip(("enc", "encp", "first"), grads[-3:], cj[1:]):
        got[name], want[name] = g.float(), _t(w)
    return got, want, grads


@pytest.mark.parametrize("af", [False, True])
def test_bf16_plain_backward_matches_jax_kernel_vjp(models, af):
    got, want, grads = _vjp_case(models, af)
    # the gradients come back in their operands' dtype
    assert all(g.dtype == BF for g in grads if g is not None)
    used = [k for k in got if af or not k.startswith("prenet.")]
    assert len(used) >= 20
    errs = {k: _rel(got[k], want[k]) for k in used}
    assert max(errs.values()) <= 2e-2, errs


@pytest.mark.parametrize("tf", [True, False])
@pytest.mark.parametrize("B,T,G,r", [(32, 150, 100, 7), (32, 150, 200, 2),
                                     (5, 33, 7, 2)])
def test_bf16_resident_plans_count_bytes_by_element(tf, B, T, G, r):
    """The bf16 instantiations' plans: the location weight and the resident
    LSTM rows take 2 bytes an entry, the location weight's gradient stays
    float32; every region apart, 16-byte aligned and inside an H100
    block, the staged chunk no narrower than the float32 plan's."""
    dims = dict(G=G, B=B, T=T, E=256, D=256, P2=128, L=512, F=r * 80,
                P1=256, NM=80)
    plan_fn = ct.tf_resident_plan if tf else ct.af_resident_plan
    p32, p16 = plan_fn(dims), plan_fn(dims, esize=2)
    for direction in ("fwd", "bwd"):
        regions = ct.af_resident_regions(p16, direction, dims, tf=tf, esize=2)
        spans = sorted((o, o + n) for o, n in regions.values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(o % 4 == 0 for o, _ in spans)
        assert spans[-1][1] * 4 <= p16[direction]["smem_bytes"] <= ct.H100_SMEM
        assert regions["w01t"][1] * 2 == ct.NTAP * dims["D"]
        assert (p16[direction]["kc"] * p16[direction]["tp"]
                >= p32[direction]["kc"] * p32[direction]["tp"])
    assert p16["fwd"]["res_l1"] and p16["fwd"]["res_l2"]
    assert not p16["bwd"]["gw_global"]
    assert (ct.af_resident_regions(p16, "bwd", dims, tf=tf, esize=2)
            ["w01_grad"][1] == ct.NTAP * dims["D"])
    # rows whose bf16 bytes are no multiple of 16 are not bulk-copied
    odd = plan_fn(dict(dims, L=68), esize=2)
    assert not odd["fwd"]["res_l1"] and not odd["fwd"]["res_l2"]


# ---------------------------------------------------------------------------
# the bf16 losses, gradients and steps
# ---------------------------------------------------------------------------

def _batch(B, T_text, G, r, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 148, (B, T_text))
    m = rng.randn(B, N_MELS, G * r).astype(np.float32)
    a = rng.uniform(0.01, 1.0, (B, G, T_text)).astype(np.float32) ** 4
    return x, m, (a / a.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("mode", ["tf", "af_offline", "af_online"])
def test_bf16_losses_match_jax(models, mode):
    params, model = _fresh(models)
    B, T_text, G, r = 3, 10, 4, 2
    x, m, aref = _batch(B, T_text, G, r, seed=6)
    key = jax.random.PRNGKey(9)
    masks = _jax_masks(key, B, T_text, G, af=mode != "tf")
    if mode == "tf":
        loss_j, _ = jtt.loss_tf(params, jnp.asarray(x), jnp.asarray(m), JT,
                                r, key, JBF, "pallas_interpret")
        loss, attn = tt.loss_tf(model, torch.tensor(x), torch.tensor(m), r,
                                masks=masks, precision="bfloat16")
    else:
        offline = mode == "af_offline"
        coeff = 200.0 if offline else 1.0
        loss_j, _ = jtt.loss_af(params, jnp.asarray(x), jnp.asarray(m),
                                jnp.asarray(aref), JT, r, key, coeff,
                                offline, JBF, "pallas_interpret")
        loss, attn, _, _ = tt.loss_af(model, torch.tensor(x),
                                      torch.tensor(m), torch.tensor(aref),
                                      r, coeff, offline, masks=masks,
                                      precision="bfloat16")
    assert loss.dtype == attn.dtype == torch.float32
    assert abs(loss.item() - float(loss_j)) <= 2e-2 * abs(float(loss_j))


def _flat_grads(model, x, m, r, masks, precision):
    _, _, grads = tt.loss_and_grads(model, x, m, r, masks=masks,
                                    precision=precision)
    assert all(g.dtype == torch.float32 for g in grads)
    return torch.cat([g.reshape(-1) for g in grads])


def test_bf16_gradient_agrees_with_f32_and_steps_train(models):
    _, model = _fresh(models)
    B, T_text, G, r = 4, 12, 5, 2
    x, m, _ = _batch(B, T_text, G, r, seed=7)
    x, m = torch.tensor(x), torch.tensor(m)
    masks = taco.draw_masks(model, B, T_text, G,
                            torch.Generator().manual_seed(0), "cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    g32 = _flat_grads(model, x, m, r, masks, "float32")
    model.load_state_dict(sd)
    g16 = _flat_grads(model, x, m, r, masks, "bfloat16")
    cos = float(torch.dot(g32, g16) / (g32.norm() * g16.norm()))
    assert cos > 0.97, cos
    # 25 bf16 steps on one batch (fresh masks each step) lower the loss;
    # the master parameters and the optimizer state stay float32
    model.load_state_dict(sd)
    state = tt.TTSTrainState(model, make_optimizer(model, 1e-3, 1.0), 0)
    gen = torch.Generator().manual_seed(1)
    losses = [float(tt.train_step_tf(state, x, m, r, generator=gen,
                                     precision="bfloat16")["loss"])
              for _ in range(25)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())


def test_cumulative_attention_stays_f32_under_bf16():
    """The plain B6 forward in bf16 over enough groups that a bf16
    accumulator would freeze (its ulp at 256 is 2): the cumulative stream
    stays float32 and keeps the float32 running sum of the bf16 scores
    (tests/test_tacotron.py:222-255, the JAX package's rule)."""
    g = torch.Generator().manual_seed(0)
    B, T, G, D, E, L, P2, F = 1, 2, 600, 8, 8, 8, 4, 8
    shapes = ((3 * D, E + P2), (3 * D,), (3 * D, D), (3 * D,), (D, D), (D,),
              (D, 62), (D,), (L, E + D), (L,), (4 * L, L), (4 * L, L),
              (4 * L,), (4 * L, L), (4 * L, L), (4 * L,), (F, L))
    weights = [(0.1 * torch.randn(s, generator=g)).to(
        torch.float32 if name in ct.BIASES else BF)
        for name, s in zip(ct.WEIGHTS, shapes)]
    enc = torch.randn(B, T, E, generator=g).to(BF)
    encp = torch.randn(B, T, D, generator=g).to(BF)
    pre = torch.rand(G, B, P2, generator=g).to(BF)
    zm = torch.zeros(G, B, L, dtype=BF)
    mel, sc, st = ct.core_ref(pre, zm, zm, enc, encp, *weights, save=True)
    assert sc.dtype == st["cum"].dtype == torch.float32
    assert mel.dtype == st["ah"].dtype == BF
    want = torch.cumsum(sc, dim=0)[-2]            # the cumulative entering G-1
    assert float(want.max()) > 256
    assert torch.equal(st["cum"][-1], want)
    frozen = torch.zeros(B, T, dtype=BF)
    for s in sc[:-1]:
        frozen = frozen + s.to(BF)
    assert float((frozen.float() - want).abs().max()) > 10


# ---------------------------------------------------------------------------
# the CLI, and a data-parallel step over two gloo ranks
# ---------------------------------------------------------------------------

def _tts_dataset(root, n_items=8, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"item{i:03d}"
        frames = int(rng.randint(12, 24))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (N_MELS, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = "The birch canoe slid on the planks."[:10 + 3 * (i % 7)]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def test_cli_trains_in_bf16_on_cpu(tmp_path, monkeypatch):
    _tts_dataset(tmp_path / "data")
    hp = tmp_path / "hp.py"
    lines = [f"data_path = {str(tmp_path / 'data')!r}",
             "tts_model_id = 'tinybf'", "tts_precision = 'bfloat16'",
             "tts_schedule = [(2, 1e-3, 2, 4)]", "tts_checkpoint_every = 2"]
    lines += [f"tts_{k} = {v!r}" for k, v in TTS.items()]
    hp.write_text("\n".join(lines) + "\n")
    monkeypatch.chdir(tmp_path)
    train_tacotron.main(["--hp_file", str(hp), "--force_cpu"])
    ckpt = tmp_path / "checkpoints" / "tinybf.tacotron"
    flat = ck.load_flat(ckpt / "latest_weights.npz")
    floats = [v for v in flat.values() if v.dtype.kind == "f"]
    assert len(floats) > 50
    assert all(v.dtype == np.float32 and np.isfinite(v).all()
               for v in floats)
    assert int(flat["meta/step"]) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bf16_step_on_two_gloo_ranks_matches_one_process(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(rank), "--world",
             str(WORLD), "--dir", str(tmp_path)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        loss, gnorm, params = _dp_step(None, slice(0, DP_B))
        logs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-4000:]}"
    ranks = []
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for r_loss, r_gnorm, r_params in ranks:
        assert abs(r_loss - loss) <= 1e-3 * abs(loss)
        assert abs(r_gnorm - gnorm) <= 1e-3 * abs(gnorm)
        for k, v in params.items():
            assert r_params[k].dtype == torch.float32
            assert float((r_params[k] - v).abs().max()) <= 2 * DP_LR + 1e-6, k
    assert all(torch.equal(ranks[0][2][k], ranks[1][2][k]) for k in params)
