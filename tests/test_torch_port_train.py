"""Port parity: WaveRNN training (``wavernn_tpu_torch.train``) against the
JAX package on the CPU: the training forward, both losses, one optimizer
step, the collate, checkpoints read by both packages, and the CLI end to
end.

Weights: JAX ``init_wavernn`` -> numpy -> the port's weight bridge. Data:
numpy from a seed, the same arrays on both sides. The port runs its
default recurrence ("auto": ``gru_seq_tm``, on the CPU its plain
versions); the JAX step runs ``recurrence="scan"``, the plain reference
of its kernel, which tests/test_pallas_gru.py:88-120 shows equal to the
interpret-mode kernel.

Tolerances (float32 on both sides; the differences are summation order):
- logits 2e-5 and BatchNorm running statistics 1e-6, absolute;
- the losses 1e-6 relative;
- one train step, with the clip inactive (4.0) and active (0.01): loss
  and grad_norm 1e-5 relative; every gradient within 1e-4 of its largest
  entry; the BatchNorm statistics and every updated weight within 1e-5
  absolute at lr 1e-4, except the weights whose gradient is below 1e-6:
  Adam's first step moves a weight by lr * g / (|g| + 1e-8), so where |g|
  is near that epsilon a rounding-level difference of g moves the step by
  up to 2 lr, and those are held to 2 lr;
- a bfloat16 step: loss and grad_norm 2e-2 relative and the parameters
  2.5e-4 absolute. The two packages round the bf16 core at other places
  (JAX's scan in bf16 throughout, the port's recurrence in float32 with
  bf16 streams) and Adam's first step moves each weight by about lr, so
  parameters are held to 2.5 lr;
- the collate exactly, and checkpoints bit for bit;
- the prefetch thread: order and values, a producer's exception
  re-raised, and the producer gone once the consumer leaves.
"""
import copy
import json
import pickle
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.config import WaveRNNTrainConfig as JTrain
from wavernn_tpu.data.dataset import collate_vocoder as j_collate
from wavernn_tpu.models import distribution as jdist
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.paths import Workspace as JWorkspace
from wavernn_tpu.synthesis import gen_testset as j_gen_testset
from wavernn_tpu.train import checkpoints as jck
from wavernn_tpu.train import wavernn_train as jwt
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.cli import train_wavernn
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.compat.to_jax import jax_flat_from_state_dict
from wavernn_tpu_torch.config import Config, WaveRNNConfig, WaveRNNTrainConfig
from wavernn_tpu_torch.data.dataset import collate_vocoder
from wavernn_tpu_torch.data.prefetch import prefetch
from wavernn_tpu_torch.models import distribution as dist
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.paths import Workspace
from wavernn_tpu_torch.synthesis import gen_testset
from wavernn_tpu_torch.train import checkpoints as ck
from wavernn_tpu_torch.train import wavernn_train as wt

VOC = dict(rnn_dims=64, fc_dims=64, compute_dims=16, res_out_dims=32,
           res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
HOP = 275
SEQ = 2 * HOP
B = 4
LR = 1e-4


def _batch(mode, seed=0):
    rng = np.random.RandomState(seed)
    mel_win = SEQ // HOP + 2 * VOC["pad"]
    x = rng.uniform(-1, 1, (B, SEQ)).astype(np.float32)
    if mode == "MOL":
        y = rng.uniform(-1, 1, (B, SEQ)).astype(np.float32)
    else:
        y = rng.randint(0, 2 ** 9, (B, SEQ)).astype(np.int64)
    m = rng.uniform(0, 1, (B, 80, mel_win)).astype(np.float32)
    return x, y, m


def _models(mode, seed=0):
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    cfg = Config(voc=WaveRNNConfig(mode=mode, **VOC))
    model = wr.WaveRNN(cfg.voc, cfg.dsp)
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params), cfg),
                          strict=True)
    return jvoc, params, cfg, model


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _bn_stats(flat):
    return {k: v for k, v in flat.items() if k.endswith(("/mean", "/var"))}


@pytest.mark.parametrize("mode,recurrence", [("MOL", "auto"), ("RAW", "auto"),
                                             ("MOL", "scan")])
def test_training_forward_matches_jax(mode, recurrence):
    jvoc, params, cfg, model = _models(mode)
    x, y, m = _batch(mode)
    want, new_p = jwr.forward(params, jnp.asarray(x), jnp.asarray(m), jvoc,
                              training=True)
    got = wr.forward(model, *_t(x, m), training=True, recurrence=recurrence)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    want_bn = _bn_stats(tree_to_flat(new_p))
    got_bn = _bn_stats(jax_flat_from_state_dict(model.state_dict()))
    assert sorted(got_bn) == sorted(want_bn) and len(got_bn) == 6
    for k in want_bn:
        np.testing.assert_allclose(got_bn[k], want_bn[k], atol=1e-6,
                                   err_msg=k)


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    y_hat = rng.randn(3, 50, 30).astype(np.float32)
    y = np.clip(rng.uniform(-1.1, 1.1, (3, 50)), -1, 1).astype(np.float32)
    y[0, :3] = [-1.0, 1.0, 0.9995]      # both edge branches
    want = float(jdist.discretized_mix_logistic_loss(jnp.asarray(y_hat),
                                                     jnp.asarray(y)))
    got = float(dist.discretized_mix_logistic_loss(*_t(y_hat, y)))
    assert abs(got - want) <= 1e-6 * abs(want)
    assert float(wt.logits_loss(*_t(y_hat, y), "MOL")) == got
    logits = rng.randn(3, 50, 512).astype(np.float32)
    labels = rng.randint(0, 512, (3, 50))
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    want = float(-jnp.mean(jnp.take_along_axis(lp, jnp.asarray(labels)[..., None],
                                               axis=-1)))
    got = float(wt.logits_loss(*_t(logits, labels), "RAW"))
    assert abs(got - want) <= 1e-6 * abs(want)


def _step_both(mode, clip, precision):
    """One step on each side from the same weights and batch: (loss,
    grad_norm, updated flat params, flat gradients) for JAX and the port;
    the gradients only in float32."""
    jvoc, params, cfg, model = _models(mode, seed=1)
    x, y, m = _batch(mode, seed=2)
    jgrads = pgrads = {}
    if precision == "float32":
        jgrads = tree_to_flat(jax.grad(lambda p: jwt.loss_fn(
            p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), jvoc, JDSP(),
            None, "scan")[0])(params))
        _, pgrads = wt.loss_and_grads(copy.deepcopy(model), *_t(x, y, m),
                                      cfg.voc)
        pgrads = jax_flat_from_state_dict(
            {n: g for (n, _), g in zip(model.named_parameters(), pgrads)})
    jstate = jwt.TrainState(params, jwt.make_optimizer(LR, clip).init(params),
                            jnp.zeros((), jnp.int32))
    jnew, jm = jwt.train_step(jstate, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(m), jvoc, JDSP(), LR, clip,
                              precision, None, "scan")
    state = wt.TrainState(model, wt.make_optimizer(model, LR, clip), 0)
    pm = wt.train_step(state, *_t(x, y, m), cfg.voc, precision, "auto")
    assert state.step == 1
    return (float(jm["loss"]), float(jm["grad_norm"]),
            tree_to_flat(jnew.params), jgrads), (
        float(pm["loss"]), float(pm["grad_norm"]),
        jax_flat_from_state_dict(model.state_dict()), pgrads)


@pytest.mark.parametrize("clip", [4.0, 0.01])
def test_train_step_matches_jax(clip):
    (jl, jg, jp, jgr), (pl, pg, pp, pgr) = _step_both("MOL", clip, "float32")
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert abs(pg - jg) <= 1e-5 * abs(jg)
    # the clip is active at 0.01 and not at 4.0
    assert (jg > clip) == (clip < 1.0)
    assert sorted(pp) == sorted(jp)
    for k, g in jgr.items():
        if k not in pgr:        # BatchNorm statistics: no gradient in JAX
            assert not g.any(), k
            continue
        scale = np.abs(g).max()
        assert np.abs(pgr[k] - g).max() <= 1e-4 * scale, k
    for k in jp:
        if k not in pgr:            # BatchNorm running statistics
            np.testing.assert_allclose(pp[k], jp[k], atol=1e-5, err_msg=k)
            continue
        # Adam's first step moves a weight by lr * g / (|g| + 1e-8): where
        # |g| is within 100x of that epsilon, a rounding-level difference
        # of g moves the step by up to 2 lr, so those weights are held to
        # Adam's step bound and every other one to 1e-5
        stiff = np.abs(jgr[k]) < 1e-6
        d = np.abs(pp[k] - jp[k])
        assert d[~stiff].max(initial=0) <= 1e-5, k
        assert d[stiff].max(initial=0) <= 2 * LR + 1e-7, k


def test_bf16_train_step_close_to_jax():
    (jl, jg, jp, _), (pl, pg, pp, _) = _step_both("MOL", 4.0, "bfloat16")
    assert np.isfinite(pl) and np.isfinite(pg)
    assert abs(pl - jl) <= 2e-2 * abs(jl)
    assert abs(pg - jg) <= 2e-2 * abs(jg)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=2.5 * LR, err_msg=k)


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_collate_matches_jax(mode):
    rng = np.random.RandomState(3)
    items = [(rng.uniform(0, 1, (80, 30 + 3 * i)).astype(np.float32),
              rng.randint(0, 2 ** 16, (30 + 3 * i) * HOP).astype(np.int64))
             for i in range(5)]
    jcfg = JConfig(voc=JVoc(mode=mode), voc_train=JTrain(seq_len=SEQ))
    cfg = Config(voc=WaveRNNConfig(mode=mode),
                 voc_train=WaveRNNTrainConfig(seq_len=SEQ))
    want = j_collate(items, jcfg, np.random.RandomState(11))
    got = collate_vocoder(items, cfg, np.random.RandomState(11))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_state_after_step(clip):
    jvoc, params, _, _ = _models("MOL", seed=3)
    x, y, m = _batch("MOL", seed=4)
    tx = jwt.make_optimizer(LR, clip)
    st = jwt.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    st, _ = jwt.train_step(st, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                           jvoc, JDSP(), LR, clip, "float32", None, "scan")
    return st


@pytest.mark.parametrize("clip", [4.0, None])
def test_jax_checkpoint_resumes_in_port(tmp_path, clip):
    st = _jax_state_after_step(clip)
    jws = JWorkspace(tmp_path / "data", "voc", "tts", output_root=tmp_path)
    jck.save_checkpoint("voc", jws, st.params, st.opt_state, 7)
    cfg = Config(voc=WaveRNNConfig(**VOC))
    ws = Workspace(tmp_path / "data", "voc", "tts", output_root=tmp_path)
    state = wt.create_train_state(cfg.voc, cfg.dsp, LR, clip, seed=9,
                                  device="cpu")
    step = ck.restore_checkpoint("voc", ws, state.model, state.opt)
    assert step == 7 and int(state.model.step) == 7
    flat = tree_to_flat({"opt": st.opt_state})
    prefix = "opt/1/0/" if clip else "opt/0/0/"
    params = dict(state.model.named_parameters())
    ours = ck.optimizer_flat(state.model, state.opt)
    assert sorted(ours) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert int(flat[prefix + ".count"]) == 1
    adam = state.opt.adam.state[params["rnn1.weight_hh_l0"]]
    np.testing.assert_array_equal(
        adam["exp_avg"].numpy(), flat[prefix + ".mu/rnn1/wh"].T)
    got = jax_flat_from_state_dict(state.model.state_dict())
    for k, v in tree_to_flat(st.params).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    _, params, cfg, model = _models("MOL", seed=5)
    x, y, m = _batch("MOL", seed=6)
    state = wt.TrainState(model, wt.make_optimizer(model, LR, 4.0), 0)
    wt.train_step(state, *_t(x, y, m), cfg.voc)
    ws = Workspace(tmp_path / "data", "voc", "tts", output_root=tmp_path)
    ck.save_checkpoint("voc", ws, model, state.opt, 11, name="snap",
                       log=lambda *_: None)
    assert ws.get_voc_named_weights("snap").exists()
    jws = JWorkspace(tmp_path / "data", "voc", "tts", output_root=tmp_path)
    tx = jwt.make_optimizer(LR, 4.0)
    jp, jo, step = jck.restore_checkpoint("voc", jws, params, tx.init(params))
    assert step == 11
    want = jax_flat_from_state_dict(model.state_dict())
    for k, v in tree_to_flat(jp).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    flat = tree_to_flat({"opt": jo})
    assert int(flat["opt/1/0/.count"]) == 1
    mu = dict(model.named_parameters())["fc1.weight"]
    np.testing.assert_array_equal(
        flat["opt/1/0/.mu/fc1/w"],
        state.opt.adam.state[mu]["exp_avg"].numpy().T)
    assert not flat["opt/1/0/.nu/upsample/resnet/bn/mean"].any()


def _dataset(root, n_items=10, frames=24, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    (root / "quant").mkdir()
    ids = []
    t = np.arange(frames * HOP) / 22050.0
    for i in range(n_items):
        name = f"item{i:03d}"
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        wave = 0.5 * np.sin(2 * np.pi * (200 + 20 * i) * t) \
            + 0.01 * rng.randn(t.size)
        q = np.clip((wave + 1) / 2 * (2 ** 16 - 1), 0, 2 ** 16 - 1)
        np.save(root / "quant" / f"{name}.npy", q.astype(np.int64))
        ids.append((name, frames))
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)


def test_cli_trains_checkpoints_resumes_and_generates(tmp_path, monkeypatch,
                                                     capsys):
    _dataset(tmp_path / "data")
    hp = tmp_path / "hparams_tiny.py"
    hp.write_text(
        "".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
        + f"data_path = {str(tmp_path / 'data')!r}\n"
        + "voc_model_id = 'tiny'\nvoc_batch_size = 4\n"
        + f"voc_seq_len = {SEQ}\nvoc_total_steps = 3\n"
        + "voc_checkpoint_every = 2\nvoc_gen_at_checkpoint = 1\n"
        + "voc_test_samples = 2\nvoc_target = 1100\nvoc_overlap = 275\n")
    monkeypatch.chdir(tmp_path)
    train_wavernn.main(["--hp_file", str(hp), "--force_cpu", "--profile_dir",
                        str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    ckpt = tmp_path / "checkpoints" / "tiny.wavernn"
    for name in ("latest_weights.npz", "latest_optim.npz",
                 "wave_step0K_weights.npz", "wave_step0K_optim.npz",
                 "log.txt", "metrics.jsonl"):
        assert (ckpt / name).exists(), name
    with np.load(ckpt / "latest_weights.npz") as z:
        assert int(z["meta/step"]) == 3
    records = [json.loads(ln) for ln in
               (ckpt / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if r["event"] == "epoch"]
    assert [r["step"] for r in epochs] == [2, 3]
    assert all(np.isfinite(r["loss"]) and r["nonfinite_grad_steps"] == 0
               for r in epochs)
    assert [r["step"] for r in records if r["event"] == "checkpoint"] == [2]
    out = tmp_path / "model_outputs" / "tiny.wavernn"
    wavs = sorted(p.name for p in out.iterdir())
    assert wavs == ["0k_steps_1_gen_batched_target1100_overlap275.wav",
                    "0k_steps_1_target.wav"]
    from scipy.io import wavfile
    _, pcm = wavfile.read(out / wavs[0])
    assert pcm.shape == ((24 - 1) * HOP,)
    assert "Training Complete." in capsys.readouterr().out
    # a second run resumes at step 3 and has nothing left to do
    train_wavernn.main(["--hp_file", str(hp), "--force_cpu"])
    text = capsys.readouterr().out
    assert "Restored checkpoint" in text and "Training Complete." in text
    assert len((ckpt / "metrics.jsonl").read_text().splitlines()) == 3


def test_cli_help_lists_reference_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        train_wavernn.main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--lr", "--batch_size", "--force_train", "--gta",
                 "--force_cpu", "--hp_file", "--prune", "--profile_dir"):
        assert flag in text, flag


def test_cli_missing_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_wavernn.main([])
        with pytest.raises(RuntimeError, match="CUDA"):
            train_wavernn.main(["--prune"])


def test_gen_testset_names_match_jax(tmp_path, monkeypatch):
    """``gen_testset`` fold-batched and unbatched writes the JAX package's
    file names, and the trainer's checkpoint generation follows
    ``voc_gen_batched`` as the JAX trainer does."""
    _, params, cfg, model = _models("MOL", seed=8)
    rng = np.random.RandomState(9)
    test_set = [(rng.uniform(0, 1, (80, 8)).astype(np.float32),
                 rng.randint(0, 2 ** 16, 8 * HOP).astype(np.int64))]
    jcfg = JConfig(voc=JVoc(mode="MOL", **VOC))
    for batched in (True, False):
        jdir, pdir = tmp_path / f"j{batched}", tmp_path / f"p{batched}"
        j_gen_testset(params, test_set, 1, batched, 1100, 275, jdir, jcfg,
                      step=3000, log=lambda *_: None)
        paths = gen_testset(model, test_set, 1, batched, 1100, 275, pdir,
                            cfg, step=3000, log=lambda *_: None,
                            device="cpu")
        names = sorted(p.name for p in jdir.iterdir())
        assert sorted(p.name for p in pdir.iterdir()) == names
        assert [p.name for p in paths] == [n for n in names
                                           if "target.wav" not in n]
    assert "3k_steps_1_gen_NOT_BATCHED.wav" in names
    _dataset(tmp_path / "data", n_items=6)
    hp = tmp_path / "hp_unbatched.py"
    hp.write_text(
        "".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
        + f"data_path = {str(tmp_path / 'data')!r}\n"
        + "voc_model_id = 'ub'\nvoc_batch_size = 2\n"
        + f"voc_seq_len = {SEQ}\nvoc_total_steps = 1\n"
        + "voc_checkpoint_every = 1\nvoc_gen_at_checkpoint = 1\n"
        + "voc_test_samples = 1\nvoc_gen_batched = False\n")
    monkeypatch.chdir(tmp_path)
    train_wavernn.main(["--hp_file", str(hp), "--force_cpu"])
    assert sorted(p.name for p in (tmp_path / "model_outputs"
                                   / "ub.wavernn").iterdir()) \
        == ["0k_steps_1_gen_NOT_BATCHED.wav", "0k_steps_1_target.wav"]


def test_prefetch_yields_tensors_in_order():
    batches = [(np.full((2, 3), i, np.float32), [f"id{i}"]) for i in range(7)]
    out = list(prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 7
    for i, (arr, ids) in enumerate(out):
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
        np.testing.assert_array_equal(arr.numpy(), batches[i][0])
        assert ids == [f"id{i}"]


def test_prefetch_reraises_producer_exception():
    def gen():
        yield (np.zeros((1,)),)
        raise ValueError("boom")

    it = prefetch(gen(), size=2)
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_producer_exits_when_consumer_leaves():
    """The train loop breaks out of ``for batch in prefetch(...)`` at its
    last step: the producer must stop rather than block in a full queue."""
    before = {t.ident for t in threading.enumerate()}
    it = prefetch((np.full((4,), i, np.float32) for i in range(1000)), size=2)
    assert next(it) is not None
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, f"prefetch producer thread leaked: {alive}"
