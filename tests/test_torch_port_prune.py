"""Port parity, pruning (``wavernn_tpu_torch.train.pruning``) against the
JAX package on the CPU: the cubic schedule, the masks (whole (128, 128)
and (8, 128) blocks, unstructured, the ragged aux tail, two schedule
points), the Pruner's lifecycle, a pruned train step, and the CLI journey
``train_wavernn --prune`` -> ``gen_wavernn --sparse`` / ``gen_tacotron
--sparse``.

Weights: JAX ``init_wavernn`` -> the port's weight bridge, at rnn and fc
256 so that every gate split holds 2 x 2 blocks of (128, 128), as in
tests/test_cli_prune_sparse.py. The JAX masks are (in, out); the port's
(out, in) masks must equal them transposed, exactly.

Tolerances: the schedule and the masks exactly (both compute z(t) and
k = int(n z) in float32); the pruned train step as the unpruned one in
tests/test_torch_port_train.py (loss and grad_norm 1e-5 relative, every
updated weight 1e-5 absolute, 2 lr where Adam's epsilon makes the step
stiff), with every masked entry exactly 0 on both sides; the sparse CLI
run's audio equals the dense run's on the same pruned checkpoint within
1e-6, as the JAX test holds it.
"""
import copy
import functools
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.cli.common import load_voc_weights as j_load_voc_weights
from wavernn_tpu.config import Config as JConfig
from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops import pallas_gen as jpg
from wavernn_tpu.paths import Workspace as JWorkspace
from wavernn_tpu.train import checkpoints as jck
from wavernn_tpu.train import pruning as jpr
from wavernn_tpu.train import wavernn_train as jwt
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.cli import gen_tacotron, gen_wavernn, train_wavernn
from wavernn_tpu_torch.cli.common import load_voc_model, make_workspace
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.compat.to_jax import jax_flat_from_state_dict
from wavernn_tpu_torch.config import Config, WaveRNNConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen
from wavernn_tpu_torch.train import pruning as P
from wavernn_tpu_torch.train import wavernn_train as wt
from wavernn_tpu_torch.train.checkpoints import save_checkpoint

VOC = dict(rnn_dims=256, fc_dims=256, compute_dims=16, res_out_dims=16,
           res_blocks=1)
HOP = 275
LR = 1e-4
Z = 0.9375
# JAX parameter path -> the port's state-dict name
NAMES = {"rnn1/wi": "rnn1.weight_ih_l0", "rnn1/wh": "rnn1.weight_hh_l0",
         "rnn2/wi": "rnn2.weight_ih_l0", "rnn2/wh": "rnn2.weight_hh_l0",
         "fc1/w": "fc1.weight", "fc2/w": "fc2.weight", "fc3/w": "fc3.weight"}


def _models(mode, seed=0, **over):
    voc = {**VOC, **over}
    jvoc = JVoc(mode=mode, **voc)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    cfg = Config(voc=WaveRNNConfig(mode=mode, **voc))
    model = wr.WaveRNN(cfg.voc, cfg.dsp)
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params), cfg),
                          strict=True)
    return jvoc, params, cfg, model


def _assert_masks_equal(pm, jm):
    assert sorted(pm) == sorted(NAMES[k] for k in jm)
    for k, m in jm.items():
        np.testing.assert_array_equal(pm[NAMES[k]].numpy(), np.asarray(m).T,
                                      err_msg=k)


def test_sparsity_schedule_equals_jax():
    for t0, S, z in ((0, 100, Z), (1000, 10_000, 0.9), (20_000, 200_000, Z)):
        for t in list(range(t0 - 3, t0 + S + 40, max(1, S // 37))):
            want = jpr.sparsity_at(jnp.asarray(t, jnp.float32), t0, S, z)
            got = P.sparsity_at(t, t0, S, z)
            assert got.dtype == torch.float32
            assert float(got) == float(want), (t0, S, t)


@pytest.mark.parametrize("mode,block,t", [
    ("RAW", (128, 128), 40), ("RAW", (128, 128), 100),
    ("MOL", (128, 128), 100), ("MOL", None, 40), ("RAW", None, 100),
    ("MOL", (8, 128), 60)])
def test_update_masks_equal_jax(mode, block, t):
    """RAW's fc3 (512 classes) is block-pruned, MOL's (30) unstructured;
    rnn2's, fc1's and fc2's last A = 4 input columns are the ragged tail."""
    _, params, _, model = _models(mode, seed=1)
    jspec, spec = jpr.wavernn_prune_spec(), P.wavernn_prune_spec()
    jm = jpr.update_masks(params, None, jnp.asarray(t), jspec, 0, 100, Z,
                          block)
    pm = P.update_masks(dict(model.named_parameters()), t, spec, 0, 100, Z,
                        block)
    _assert_masks_equal(pm, jm)
    if block == (128, 128):
        # whole (128, 128) blocks of the leading 256 input columns
        M = pm["rnn2.weight_ih_l0"][:, :256].reshape(6, 128, 2, 128)
        assert bool((M.amax(dim=(1, 3)) == M.amin(dim=(1, 3))).all())


def test_pruner_lifecycle_equals_jax():
    """masks_for_step: None before t0, ones at t0, recomputed when t > t0
    and t % every == 0, kept in between; restart recomputes at t; the
    counts (tests/test_pruning.py:45-78)."""
    _, params, _, model = _models("MOL", seed=2, rnn_dims=64, fc_dims=64)
    named = dict(model.named_parameters())
    spec, jspec = P.wavernn_prune_spec(False), jpr.wavernn_prune_spec(False)
    pr = P.Pruner(spec, 10, 100, 0.9, prune_every=20)
    jp = jpr.Pruner(jspec, 10, 100, 0.9, prune_every=20)
    assert pr.masks_for_step(named, 5) is None
    assert jp.masks_for_step(params, 5) is None
    assert pr.num_pruned() == 0 and pr.total_params() == 0
    ones = pr.masks_for_step(named, 10)
    assert all(bool((m == 1).all()) for m in ones.values())
    for t in (30, 40, 41, 200):
        _assert_masks_equal(pr.masks_for_step(named, t),
                            jp.masks_for_step(params, t))
        if t == 40:
            frac = float((pr.masks["rnn1.weight_hh_l0"] == 0).float().mean())
            assert abs(frac - float(P.sparsity_at(40, 10, 100, 0.9))) < 0.05
            at40 = {k: v.clone() for k, v in pr.masks.items()}
    assert pr.num_pruned() == jp.num_pruned() > 0
    assert pr.total_params() == jp.total_params() == sum(
        named[n].numel() for n, _ in spec.entries)
    pr2 = P.Pruner(spec, 10, 100, 0.9, 20)
    for k, m in pr2.restart(named, 40).items():
        assert torch.equal(m, at40[k]), k


def test_pruned_train_step_matches_jax():
    """One optimizer step, then the masks, from the same weights, batch and
    (128, 128) block masks; the Adam moments are not masked."""
    jvoc, params, cfg, model = _models("MOL", seed=3)
    rng = np.random.RandomState(4)
    B, SEQ = 4, 2 * HOP     # the batch shape of the unpruned step's test
    x = rng.uniform(-1, 1, (B, SEQ)).astype(np.float32)
    y = rng.uniform(-1, 1, (B, SEQ)).astype(np.float32)
    m = rng.uniform(0, 1, (B, 80, SEQ // HOP + 4)).astype(np.float32)
    t, block = 60, (128, 128)
    jmasks = jpr.update_masks(params, None, jnp.asarray(t),
                              jpr.wavernn_prune_spec(), 0, 100, Z, block)
    masks = P.update_masks(dict(model.named_parameters()), t,
                           P.wavernn_prune_spec(), 0, 100, Z, block)
    jst = jwt.TrainState(params, jwt.make_optimizer(LR, 4.0).init(params),
                         jnp.zeros((), jnp.int32))
    jnew, jm = jwt.train_step(jst, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(m), jvoc, JDSP(), LR, 4.0,
                              "float32", jmasks, "scan")
    # the gradients, for where Adam's step is stiff (|g| near its epsilon)
    _, grads = wt.loss_and_grads(copy.deepcopy(model),
                                 *map(torch.from_numpy, (x, y, m)), cfg.voc)
    grads = jax_flat_from_state_dict(
        {n: g for (n, _), g in zip(model.named_parameters(), grads)})
    state = wt.TrainState(model, wt.make_optimizer(model, LR, 4.0), 0)
    pm = wt.train_step(state, *map(torch.from_numpy, (x, y, m)), cfg.voc,
                       masks=masks)
    assert abs(float(pm["loss"]) - float(jm["loss"])) \
        <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-5 * abs(float(jm["grad_norm"]))
    jp = tree_to_flat(jnew.params)
    pp = jax_flat_from_state_dict(model.state_dict())
    for k in jp:
        if k in NAMES:
            dead = np.asarray(jmasks[k]) == 0
            assert dead.any() and not jp[k][dead].any() \
                and not pp[k][dead].any(), k
        if k.endswith(("/mean", "/var")):
            np.testing.assert_allclose(pp[k], jp[k], atol=1e-5, err_msg=k)
            continue
        stiff = np.abs(grads[k]) < 1e-6
        d = np.abs(pp[k] - jp[k])
        assert d[~stiff].max(initial=0) <= 1e-5, k
        assert d[stiff].max(initial=0) <= 2 * LR + 1e-7, k
    # Adam's moments keep the pruned entries' gradient history
    adam = state.opt.adam.state[dict(model.named_parameters())[
        "rnn1.weight_hh_l0"]]
    assert bool((adam["exp_avg"][masks["rnn1.weight_hh_l0"] == 0] != 0).any())


# ---- the CLI journey (tests/test_cli_prune_sparse.py) ----

TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256,
           postnet_dims=32, encoder_K=2, lstm_dims=64, postnet_K=2,
           num_highways=1)


def _raw_dataset(root, n_items=12, seed=0):
    """A vocoder dataset in the reference layout (mel/*.npy, quant/*.npy
    with 9-bit labels, dataset.pkl), sine waves as the JAX test's."""
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    (root / "quant").mkdir()
    ids = []
    for i in range(n_items):
        frames = rng.randint(13, 16)   # the collate crops 12 + 1 frames
        t = np.arange(frames * HOP) / 22050.0
        wave = 0.4 * np.sin(2 * np.pi * (220 + 15 * i) * t)
        q = np.clip(np.round((wave + 1) / 2 * 511), 0, 511).astype(np.int64)
        np.save(root / "mel" / f"p{i:02d}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        np.save(root / "quant" / f"p{i:02d}.npy", q)
        ids.append((f"p{i:02d}", frames))
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)


@pytest.fixture(scope="module")
def journey(tmp_path_factory):
    root = tmp_path_factory.mktemp("prune_journey")
    _raw_dataset(root / "data")
    hp = root / "hparams_prune.py"
    hp.write_text(
        "".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
        + "".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items())
        + f"data_path = {str(root / 'data')!r}\n"
        + "voc_model_id = 'prune_voc'\ntts_model_id = 'prune_tts'\n"
        + "voc_mode = 'RAW'\nvoc_batch_size = 4\nvoc_total_steps = 3\n"
        + "voc_checkpoint_every = 1000\nvoc_test_samples = 2\n"
        + f"voc_seq_len = {2 * HOP}\nvoc_target = 2200\n"
        + "voc_overlap = 550\nvoc_prune_start = 0\n"
        + "voc_prune_steps = 1\nvoc_prune_sparsity = 0.75\n"
        + "voc_prune_every = 1\ntts_stop_threshold = 10.0\n")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        train_wavernn.main(["--hp_file", str(hp), "--force_cpu", "--prune"])
        yield root, hp
    finally:
        os.chdir(cwd)


def test_cli_prune_trains_block_dead_weights(journey, capsys):
    root, hp = journey
    ckpt = root / "checkpoints" / "prune_voc.wavernn" / "latest_weights.npz"
    with np.load(ckpt) as z:
        assert int(z["meta/step"]) == 3
        wh1 = z["params/rnn1/wh"]                    # (in, out)
    blocks = np.abs(wh1).reshape(2, 128, 6, 128).sum(axis=(1, 3))
    dead = float((blocks == 0).mean())
    # 75 % block sparsity per gate split: 3 of its 4 blocks dead
    assert 0.5 <= dead < 1.0, dead
    # the JAX package's packer engages on the port's checkpoint
    cfg = JConfig.from_hparams_file(hp)
    jparams, _ = j_load_voc_weights(str(ckpt), cfg)
    static, _ = jpg.pack_sparse(jparams, cfg.voc)
    names = {name for name, _, _ in static}
    assert {"wh1", "wh2"} <= names, names
    # and the port's on the same checkpoint finds the same live blocks
    pcfg = Config.from_hparams_file(hp)
    voc, _ = load_voc_model(ckpt, pcfg, "cpu")
    pack = cuda_gen.pack_sparse(voc.core_weights(), pcfg.voc)
    assert {n: pack.entries[n].rows for n in pack.entries} \
        == {n: rows for n, _, rows in static}


def test_cli_gen_wavernn_sparse_equals_dense(journey, capsys):
    root, hp = journey
    out_dir = root / "model_outputs" / "prune_voc.wavernn"
    name = out_dir / "0k_steps_1_gen_NOT_BATCHED.wav"
    gen_wavernn.main(["--hp_file", str(hp), "--samples", "1", "--unbatched",
                      "--force_cpu"])
    from scipy.io import wavfile
    dense = wavfile.read(name)[1].astype(np.float64) / 2 ** 15
    gen_wavernn.main(["--hp_file", str(hp), "--samples", "1", "--unbatched",
                      "--force_cpu", "--sparse"])
    assert "serving dense" not in capsys.readouterr().out
    sparse = wavfile.read(name)[1].astype(np.float64) / 2 ** 15
    assert dense.size > 0
    np.testing.assert_allclose(sparse, dense, atol=1e-6)
    # a saved [0, 1] mel through --file, fold-batched, sparse
    mel = np.load(root / "data" / "mel" / "p00.npy")
    np.save(root / "m.npy", mel)
    gen_wavernn.main(["--hp_file", str(hp), "--file", str(root / "m.npy"),
                      "--force_cpu", "--sparse", "-b", "--pallas"])
    got = out_dir / "__m__0k_steps_gen_batched_target2200_overlap550.wav"
    assert wavfile.read(got)[1].shape == ((mel.shape[1] - 1) * HOP,)
    # a .wav through --file: its mel computed again, its copy saved as the
    # target, the vocoder's output as long as the mel
    from wavernn_tpu_torch.dsp.audio import save_wav
    wav = 0.5 * np.sin(2 * np.pi * 220 * np.arange(8 * HOP) / 22050)
    save_wav(wav, root / "x.wav")
    gen_wavernn.main(["--hp_file", str(hp), "--file", str(root / "x.wav"),
                      "--force_cpu"])
    assert (out_dir / "__x__0k_steps_target.wav").is_file()
    got = out_dir / "__x__0k_steps_gen_batched_target2200_overlap550.wav"
    assert wavfile.read(got)[1].shape == (8 * HOP,)


def test_cli_gen_tacotron_sparse_writes_wavs(journey, monkeypatch, capsys):
    """``gen_tacotron --sparse`` on the pruned vocoder and a random
    Tacotron (decode bound cut to 40 frames); an unpruned vocoder packs
    nothing and is served dense, with the JAX CLI's message."""
    root, hp = journey
    cfg = Config.from_hparams_file(hp)
    ws = make_workspace(cfg)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint("tts", ws, tts, wt.make_optimizer(tts, 1e-3), 3000, r=2,
                    log=lambda *_: None)
    for name in ("tts_to_wav", "tts_to_wav_batch"):
        monkeypatch.setattr(gen_tacotron, name, functools.partial(
            getattr(gen_tacotron, name), steps=40))
    gen_tacotron.main(["--hp_file", str(hp), "--force_cpu", "--input_text",
                       "Hello there.", "wavernn", "--sparse"])
    gen_tacotron.main(["--hp_file", str(hp), "--force_cpu", "--input_text",
                       "Hello there.", "wavernn", "--sparse",
                       "--batch_sentences"])
    assert "serving dense" not in capsys.readouterr().out
    from scipy.io import wavfile
    for v in ("wavernn_batched", "wavernn_batchN"):
        sr, pcm = wavfile.read(ws.tts_output
                               / f"__input_Hello ther_{v}_3k.wav")
        assert sr == 22050 and pcm.size > 0
    dense = wr.WaveRNN(cfg.voc, cfg.dsp)
    dense.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(dense.state_dict(), root / "dense.pyt")
    gen_tacotron.main(["--hp_file", str(hp), "--force_cpu", "--input_text",
                       "Hi.", "wavernn", "--sparse", "--voc_weights",
                       str(root / "dense.pyt")])
    assert "serving dense" in capsys.readouterr().out


def test_port_packs_a_jax_pruned_checkpoint(tmp_path):
    """A checkpoint the JAX package pruned and saved: the port's pack
    engages and finds JAX's live blocks."""
    jvoc = JVoc(mode="RAW", **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(7), jvoc, JDSP())
    spec = jpr.wavernn_prune_spec()
    params = jpr.apply_masks(params, jpr.update_masks(
        params, None, jnp.asarray(100), spec, 0, 100, Z, (128, 128)), spec)
    jws = JWorkspace(tmp_path / "data", "voc", "tts", output_root=tmp_path)
    tx = jwt.make_optimizer(LR, 4.0)
    jck.save_checkpoint("voc", jws, params, tx.init(params), 5)
    cfg = Config(voc=WaveRNNConfig(mode="RAW", **VOC))
    voc, step = load_voc_model(jws.voc_latest_weights, cfg, "cpu")
    assert step == 5
    pack = cuda_gen.pack_sparse(voc.core_weights(), cfg.voc)
    static, _ = jpg.pack_sparse(params, jvoc)
    assert sorted(pack.entries) == sorted(n for n, _, _ in static) \
        == sorted(cuda_gen.STEP_MATRICES)
    for n, _, rows in static:
        assert pack.entries[n].rows == rows, n
    # 93.75 %: one live (128, 128) block of each gate split's four
    assert sum(pack.entries[n].live() for n in cuda_gen.STEP_MATRICES) \
        == 3 + 3 + 3 + 3 + 1 + 1


def test_cli_help_and_missing_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        gen_wavernn.main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--batched", "--unbatched", "--samples", "--target",
                 "--overlap", "--file", "--weights", "--gta", "--pallas",
                 "--no_pallas", "--sparse", "--hp_file", "--force_cpu"):
        assert flag in text, flag
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gen_wavernn.main([])
