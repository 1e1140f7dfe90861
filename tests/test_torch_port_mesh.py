"""Port parity, multi-device (``wavernn_tpu_torch/parallel/mesh.py`` and
every ``mesh=`` path): a two-rank gloo cluster on the CPU against one port
process and against the JAX package's mesh programs on the conftest's
8-device CPU mesh.

The cluster is this file run as a script, twice:

    python tests/test_torch_port_mesh.py --rank R --world 2 --dir D

with ``torchrun``'s variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) set, each worker pinned to one thread. It
reads the inputs the test process wrote to D (weights from the JAX
package's initialisers through ``compat/from_jax``, numpy data from
seeds), runs every mesh case, then its half of the one-process references,
and writes its results there. The test process computes the JAX package's
mesh results meanwhile.

Cases: three data-parallel WaveRNN steps (the multiprocess worker's tiny
vocoder, rnn 32, batch 8: four rows a rank); a Tacotron teacher-forcing
step (batch 4, injected masks) and an attention-forcing step of each mode
(offline on reference maps, online on the frozen teacher's); ``batchnorm_train`` across the ranks; the
batchers' shards; ``counter_uniforms`` with ``row0`` / ``B_global``;
``generate_sharded`` (crossfade with injected noise and with the counter
hash, exact seams on frame-rate and on sample-rate folds, an odd fold
count so the last rank pads), ``generate_multi_sharded``,
``tts_to_wav_batch(mesh=)`` and ``MultiStreamVocoder(mesh=)``.

Tolerances:
- the two ranks' results are identical, and the batchers' shards and the
  counter draws equal the JAX package's / the full draw's exactly;
- against one port process: training losses and grad norms 1e-5
  relative and the parameters after the steps as ``_params_close`` says
  (Adam's epsilon); BatchNorm
  2e-6 (the statistics are summed in another order); waves and mels 1e-5:
  the CPU's batched products round a row differently at another batch
  size (tests/test_torch_port_serve_voc.py), and the sample loop carries
  that forward. On the card, where the kernels' per-row sums do not depend
  on the batch, ``chip_smoke.py``'s mesh phase holds the vocoder paths bit
  for bit;
- against the JAX package: training losses and grad norms 1e-5 relative,
  mels 2e-5 and waves 2e-3, as the one-device serving tests
  (tests/test_torch_port_serve_tts.py).
"""
import argparse
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # the CPU-thread budget

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from wavernn_tpu_torch.config import (Config, TacotronConfig,  # noqa: E402
                                      WaveRNNConfig)

WORLD = 2
HOP = 275
VOC = dict(mode="MOL", rnn_dims=32, fc_dims=32, compute_dims=16,
           res_out_dims=16, res_blocks=1, pad=2, upsample_factors=(5, 5, 11))
TTS = dict(embed_dims=32, encoder_dims=128, decoder_dims=256, postnet_dims=32,
           encoder_K=2, lstm_dims=64, postnet_K=2, num_highways=1)
TRAIN_B, TRAIN_FRAMES, LR, CLIP = 8, 7, 1e-3, 4.0
TF_B, TF_TEXT, TF_G, TF_R, TF_LR = 4, 12, 4, 2, 1e-3
TARGET, OVERLAP = 4 * HOP, HOP          # frame-rate folds (B1, B4b)
TARGET_M, OVERLAP_M = 1000, 200         # sample-rate folds (B3)
GEN_FRAMES = 22                         # 5 folds: the last rank pads one
MULTI_FRAMES = (22, 9, 15)
TEXTS = ["The birch canoe slid on the smooth planks.",
         "Glue the sheet.",
         "It's easy to tell the depth of a well, they say."]
R, STEPS, BUCKETS = 2, 40, (16, 32)
LANES, CHUNK, LANE_FRAMES = 4, 4, (10, 7, 9, 6)
NR_MIX = 10
TIMEOUT_S = 240


def _cfg():
    return Config(voc=WaveRNNConfig(**VOC), tts=TacotronConfig(**TTS))


def _noise(seed, L, B):
    rng = np.random.RandomState(seed)
    return (rng.uniform(1e-5, 1 - 1e-5, (L, B, NR_MIX)).astype(np.float32),
            rng.uniform(1e-5, 1 - 1e-5, (L, B)).astype(np.float32))


def _num_folds(n_samples, target, overlap):
    from wavernn_tpu_torch.ops.fold import num_folds_for
    return num_folds_for(n_samples, target, overlap)


def _tts_folds():
    """The combined fold count of TEXTS's waves: with these weights no
    sentence stops within STEPS (tests/test_torch_port_serve_tts.py), so
    each mel is STEPS frames."""
    return len(TEXTS) * _num_folds(STEPS * HOP, TARGET, OVERLAP)


# ---------------------------------------------------------------------------
# the port's cases: each rank of the cluster, or one process (mesh None)
# ---------------------------------------------------------------------------

def _rows(n, mesh):
    """This rank's contiguous rows of a batch of n (all of them alone)."""
    if mesh is None:
        return slice(0, n)
    from wavernn_tpu_torch.parallel.mesh import rank
    per = n // WORLD
    return slice(rank(mesh) * per, (rank(mesh) + 1) * per)


def _flat_params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def case_train_voc(inp, mesh):
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.train import wavernn_train as wt
    cfg = _cfg()
    model = wr.WaveRNN(cfg.voc, cfg.dsp)
    model.load_state_dict(inp["voc_sd"], strict=True)
    state = wt.TrainState(model, wt.make_optimizer(model, LR, CLIP), 0)
    rows = _rows(TRAIN_B, mesh)
    x, y, m = (torch.from_numpy(a[rows]) for a in inp["train_batch"])
    losses, norms = [], []
    for _ in range(3):
        out = wt.train_step(state, x, y, m, cfg.voc, mesh=mesh)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": _flat_params(model)}


def case_train_tf(inp, mesh):
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.train import tacotron_train as tt
    from wavernn_tpu_torch.train.wavernn_train import make_optimizer
    cfg = _cfg()
    model = taco.Tacotron(cfg.tts, 80)
    model.load_state_dict(inp["tts_sd"], strict=True)
    state = tt.TTSTrainState(model, make_optimizer(model, TF_LR, 1.0), 0)
    rows = _rows(TF_B, mesh)
    x, m = inp["tf_batch"]
    masks = {k: torch.from_numpy(v[rows] if k.startswith("enc")
                                 else v[:, rows])
             for k, v in inp["tf_masks"].items()}
    out = tt.train_step_tf(state, torch.from_numpy(x[rows]),
                           torch.from_numpy(m[rows]), TF_R, masks=masks,
                           mesh=mesh)
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "params": _flat_params(model)}


def case_train_af(inp, mesh):
    """One attention-forcing step of each mode: offline on reference maps
    sliced with the batch, online on the frozen teacher's maps of this
    rank's rows (the teacher's B6 forward on the shard)."""
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.train import tacotron_train as tt
    from wavernn_tpu_torch.train.wavernn_train import make_optimizer
    cfg = _cfg()
    rows = _rows(TF_B, mesh)
    x, m = (torch.from_numpy(a[rows]) for a in inp["tf_batch"])
    masks = {k: torch.from_numpy(v[rows] if k.startswith("enc")
                                 else v[:, rows])
             for k, v in inp["tf_masks"].items()}
    out = {}
    for offline in (True, False):
        model = taco.Tacotron(cfg.tts, 80)
        model.load_state_dict(inp["tts_sd"], strict=True)
        state = tt.TTSTrainState(model, make_optimizer(model, TF_LR, 1.0), 0)
        if offline:
            aref = torch.from_numpy(inp["af_ref"][rows])
        else:
            teacher = taco.Tacotron(cfg.tts, 80)
            teacher.load_state_dict(inp["tts_sd"], strict=True)
            aref = tt.teacher_attn_ref(teacher.eval(), x, m, TF_R)
        res = tt.train_step_af(state, x, m, aref, TF_R,
                               200.0 if offline else 1.0, offline,
                               masks=masks, mesh=mesh)
        out["offline" if offline else "online"] = {
            **{k: float(res[k]) for k in ("loss", "loss_out", "loss_attn",
                                          "grad_norm")},
            "params": _flat_params(model)}
    return out


def case_batchnorm(inp, mesh):
    from wavernn_tpu_torch.ops import layers as L
    x_all, w, b, g_all = (torch.from_numpy(a) for a in inp["bn"])
    rows = _rows(x_all.shape[0], mesh)
    x = x_all[rows].clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    rm, rv = torch.zeros(w.shape[0]), torch.ones(w.shape[0])
    y = L.batchnorm_train(x, w, b, rm, rv, mesh=mesh)
    (y * g_all[rows]).sum().backward()
    dw, db, dy = w.grad.clone(), b.grad.clone(), y.detach()
    dx = x.grad
    if mesh is not None:            # the whole batch's, as one process has
        from wavernn_tpu_torch.parallel.mesh import all_gather, all_reduce_
        all_reduce_(dw, mesh)
        all_reduce_(db, mesh)
        dy, dx = all_gather(dy, mesh), all_gather(dx, mesh)
    return {"y": dy, "dx": dx, "dw": dw, "db": db, "mean": rm, "var": rv}


def _serve_models(inp):
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.models import wavernn as wr
    cfg = _cfg()
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.load_state_dict(inp["voc_sd"], strict=True)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.load_state_dict(inp["tts_sd"], strict=True)
    return cfg, voc.eval(), tts.eval()


def _t(noise):
    return tuple(torch.from_numpy(u) for u in noise)


def case_serve(inp, mesh):
    from wavernn_tpu_torch.parallel import gen_sharded as gs
    from wavernn_tpu_torch.streaming import MultiStreamVocoder
    from wavernn_tpu_torch.synthesis import tts_to_wav_batch
    cfg, voc, tts = _serve_models(inp)
    mel = inp["gen_mel"]
    out = {}
    for name, target, overlap, passes in (
            ("crossfade", TARGET, OVERLAP, 0), ("seam_fused", TARGET, OVERLAP, 2),
            ("seam_mat", TARGET_M, OVERLAP_M, 2)):
        out[name] = gs.generate_sharded(
            voc, mel, mesh=mesh, target=target, overlap=overlap,
            seam_passes=passes, noise=_t(inp[f"noise_{name}"]), device="cpu")
        if name == "crossfade":
            out["crossfade_stats"] = {k: v for k, v in gs.last_stats.items()
                                      if k != "wall_s"}
    out["crossfade_hash"] = gs.generate_sharded(
        voc, mel, mesh=mesh, target=TARGET, overlap=OVERLAP,
        generator=torch.Generator().manual_seed(11), device="cpu")
    # the device post-pass (the JAX package's: float32, the tail of the
    # 20-frame ramp on a shorter wave)
    kw = dict(target=TARGET, overlap=OVERLAP, noise=_t(inp["noise_multi"]),
              device="cpu", device_out=True)
    if mesh is None:
        from wavernn_tpu_torch.models.wavernn import generate_multi
        waves = generate_multi(voc, inp["multi_mels"], **kw)
    else:
        waves = gs.generate_multi_sharded(voc, inp["multi_mels"], mesh, **kw)
    out["multi"] = [w.numpy() for w in waves]
    out["tts"] = tts_to_wav_batch(
        tts, voc, TEXTS, cfg, R, steps=STEPS, mel_buckets=BUCKETS,
        noise=_t(inp["noise_tts"]), target=TARGET, overlap=OVERLAP,
        device="cpu", mesh=mesh)
    msv = MultiStreamVocoder(voc, LANES, chunk_frames=CHUNK, mu_law=False,
                             noise=_t(inp["noise_streams"]), device="cpu",
                             mesh=mesh)
    got = {b: [] for b in range(LANES)}
    for b, m in enumerate(inp["lane_mels"]):
        msv.feed(b, m[:, :5], drain=False)
    for res in (msv.poll(),) + tuple(
            msv.feed(b, m[:, 5:]) for b, m in enumerate(inp["lane_mels"])) \
            + tuple(msv.flush(b) for b in range(LANES)):
        for b, y in res.items():
            got[b].append(y)
    out["streams"] = [np.concatenate(got[b]) for b in range(LANES)]
    return out


CLI_HP = ("".join(f"voc_{k} = {v!r}\n" for k, v in VOC.items())
          + "".join(f"tts_{k} = {v!r}\n" for k, v in TTS.items())
          + "voc_model_id = 'tiny'\nvoc_batch_size = 4\nvoc_seq_len = 550\n"
          "voc_total_steps = 3\nvoc_checkpoint_every = 2\n"
          "voc_gen_at_checkpoint = 1\nvoc_test_samples = 2\n"
          "voc_target = 1100\nvoc_overlap = 275\ntts_model_id = 'tinytts'\n"
          "tts_schedule = [(2, 1e-3, 2, 4), (5, 1e-4, 3, 4)]\n"
          "tts_checkpoint_every = 2\n")


def case_cli(inp, mesh, work):
    """Both training CLIs, as ``torchrun`` starts them, on a dataset that
    serves both (work/data): data parallel in work/cli_mesh under the
    process group, or alone in work/cli_solo."""
    from wavernn_tpu_torch.cli import train_tacotron, train_wavernn
    out = work / ("cli_solo" if mesh is None else "cli_mesh")
    out.mkdir(exist_ok=True)
    here = os.getcwd()
    os.chdir(out)
    try:
        for cli in (train_wavernn, train_tacotron):
            cli.main(["--hp_file", str(work / "hp.py"), "--force_cpu"])
    finally:
        os.chdir(here)
    return None


MESH_CASES = ("train_voc", "train_tf", "train_af", "batchnorm", "serve",
              "cli")
CASES = {"train_voc": case_train_voc, "train_tf": case_train_tf,
         "train_af": case_train_af, "batchnorm": case_batchnorm,
         "serve": case_serve}
# the one-process references, split between the two workers
SOLO = ({"train_voc", "train_tf", "batchnorm", "cli"},
        {"serve", "train_af"})


def worker(rank: int, world: int, work: Path) -> None:
    """One rank of the cluster: every mesh case, then its share of the
    one-process references."""
    from wavernn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh)
    dev = initialize_distributed("cpu")
    assert dev.type == "cpu"
    mesh = make_mesh()
    inputs = work / "inputs.pkl"     # the test process writes it meanwhile
    deadline = time.monotonic() + TIMEOUT_S
    while not inputs.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {inputs}")
        time.sleep(0.05)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    res = {"mesh": {}, "solo": {}, "seconds": {}}
    cases = {**CASES, "cli": lambda inp, mesh: case_cli(inp, mesh, work)}
    for name in MESH_CASES:
        t0 = time.perf_counter()
        res["mesh"][name] = cases[name](inp, mesh)
        res["seconds"][name] = time.perf_counter() - t0
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    os.environ["WORLD_SIZE"] = "1"   # the CLIs' one-process runs
    for name in sorted(SOLO[rank]):
        res["solo"][name] = cases[name](inp, None)
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the test process: inputs, the cluster, the JAX package's mesh results
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_masks(key, B, T_text, G, lstm):
    """The JAX TF forward's random draws under ``key`` as the port's
    injected masks (tests/test_torch_port_taco_train.py), drawn in one
    compiled program."""
    import jax
    from wavernn_tpu.config import TacotronConfig as JTTS
    from wavernn_tpu.ops.pallas_taco_train import zoneout_masks
    keep = 1.0 - JTTS().dropout

    def draw(key):
        k_enc, k_dec, k_pre = jax.random.split(key, 3)
        out = {}
        for (k1, k2), pre, rows in ((jax.random.split(k_enc), "enc",
                                     (B, T_text)),
                                    (jax.random.split(k_pre), "dec",
                                     (G * B,))):
            for name, k, width in (("drop1", k1, 256), ("drop2", k2, 128)):
                out[f"{pre}_{name}"] = jax.random.bernoulli(
                    k, keep, rows + (width,))
        out["zm1"], out["zm2"] = zoneout_masks(k_dec, G, B, lstm)
        return out
    out = {k: np.asarray(v, np.float32)
           for k, v in jax.jit(draw)(key).items()}
    for name in ("enc_drop1", "enc_drop2", "dec_drop1", "dec_drop2"):
        out[name] = out[name] / keep
    for name in ("dec_drop1", "dec_drop2"):
        out[name] = out[name].reshape(G, B, -1)
    return out


def _inputs():
    """Weights (JAX initialisers -> the port's state dicts), data and
    noise, shared by the cluster, the JAX side and the one-process side."""
    import jax
    from wavernn_tpu.config import DSPConfig as JDSP
    from wavernn_tpu.config import TacotronConfig as JTTS
    from wavernn_tpu.config import WaveRNNConfig as JVoc
    from wavernn_tpu.models import tacotron as jtaco
    from wavernn_tpu.models import wavernn as jwr
    from wavernn_tpu.train.checkpoints import tree_to_flat
    from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
    cfg = _cfg()
    jvoc, jtts = JVoc(**VOC), JTTS(**TTS)
    # create_train_state's parameters (the multiprocess worker's), each
    # initialiser compiled once instead of run op by op
    voc_p = jax.jit(jwr.init_wavernn, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jvoc, JDSP())
    tts_p = jax.jit(jtaco.init_tacotron, static_argnums=(1, 2))(
        jax.random.PRNGKey(5), jtts, 80)
    rng = np.random.RandomState(0)
    T = (TRAIN_FRAMES - 2 * VOC["pad"]) * HOP
    train_batch = (rng.uniform(-1, 1, (TRAIN_B, T)).astype(np.float32),
                   rng.uniform(-1, 1, (TRAIN_B, T)).astype(np.float32),
                   rng.uniform(0, 1, (TRAIN_B, 80, TRAIN_FRAMES))
                   .astype(np.float32))
    tf_rng = np.random.RandomState(2)
    tf_batch = (tf_rng.randint(1, 148, (TF_B, TF_TEXT)),
                tf_rng.randn(TF_B, 80, TF_G * TF_R).astype(np.float32))
    att = np.random.RandomState(3).rand(TF_B, TF_G, TF_TEXT) ** 4
    af_ref = (att / att.sum(-1, keepdims=True)).astype(np.float32)
    bn_rng = np.random.RandomState(4)
    bn = (bn_rng.randn(4, 6, 10).astype(np.float32) * 2 + 1,
          bn_rng.uniform(0.5, 1.5, 6).astype(np.float32),
          bn_rng.randn(6).astype(np.float32),
          bn_rng.randn(4, 6, 10).astype(np.float32))
    mel_rng = np.random.RandomState(7)
    gen_mel = mel_rng.uniform(0.2, 0.8, (1, 80, GEN_FRAMES)).astype(np.float32)
    multi_mels = [mel_rng.uniform(0.2, 0.8, (80, n)).astype(np.float32)
                  for n in MULTI_FRAMES]
    lane_mels = [mel_rng.uniform(0.2, 0.8, (80, n)).astype(np.float32)
                 for n in LANE_FRAMES]
    n_gen = GEN_FRAMES * HOP
    n_multi = sum(_num_folds(n * HOP, TARGET, OVERLAP) for n in MULTI_FRAMES)
    return {
        "voc_p": voc_p, "tts_p": tts_p,
        "voc_sd": state_dict_from_jax(tree_to_flat(voc_p), cfg),
        "tts_sd": state_dict_from_jax(tree_to_flat(tts_p), cfg),
        "train_batch": train_batch, "tf_batch": tf_batch,
        "tf_masks": _jax_masks(jax.random.PRNGKey(9), TF_B, TF_TEXT, TF_G,
                               TTS["lstm_dims"]),
        "af_ref": af_ref, "bn": bn, "gen_mel": gen_mel,
        "multi_mels": multi_mels,
        "lane_mels": lane_mels,
        "noise_crossfade": _noise(1, TARGET + 2 * OVERLAP,
                                  _num_folds(n_gen, TARGET, OVERLAP)),
        "noise_seam_fused": _noise(2, TARGET + 2 * OVERLAP,
                                   _num_folds(n_gen, TARGET, OVERLAP)),
        "noise_seam_mat": _noise(3, TARGET_M + 2 * OVERLAP_M,
                                 _num_folds(n_gen, TARGET_M, OVERLAP_M)),
        "noise_multi": _noise(4, TARGET + 2 * OVERLAP, n_multi),
        "noise_tts": _noise(5, TARGET + 2 * OVERLAP, _tts_folds()),
        "noise_streams": _noise(6, max(LANE_FRAMES) * HOP, LANES),
    }


def _jax_results(inp):
    """The JAX package's mesh programs on the same inputs: the training
    steps on the 8-device mesh (the multiprocess worker's), the rest on a
    2-device mesh, its scan twins (the CPU meshes' path)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from wavernn_tpu import streaming as jstream
    from wavernn_tpu.config import DSPConfig as JDSP
    from wavernn_tpu.config import TacotronConfig as JTTS
    from wavernn_tpu.config import WaveRNNConfig as JVoc
    from wavernn_tpu.models import tacotron as jtaco
    from wavernn_tpu.models import wavernn as jwr
    from wavernn_tpu.ops import fold as jF
    from wavernn_tpu.parallel import gen_sharded as jgs
    from wavernn_tpu.parallel.mesh import make_global_array, replicate
    from wavernn_tpu.text import text_to_sequence
    from wavernn_tpu.train import tacotron_train as jtt
    from wavernn_tpu.train import wavernn_train as jwt

    jvoc, jtts, dsp = JVoc(**VOC), JTTS(**TTS), JDSP()
    mesh8 = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    mesh2 = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    sh = NamedSharding(mesh2, P("data"))
    params = inp["voc_p"]        # create_train_state's, from its key
    key = jax.random.PRNGKey(0)

    def noise(name):
        return tuple(map(jnp.asarray, inp[f"noise_{name}"]))

    def training():
        st = jwt.TrainState(replicate(mesh8, params),
                            replicate(mesh8, jwt.make_optimizer(LR, CLIP)
                                      .init(params)),
                            jnp.zeros((), jnp.int32))
        x, y, m = (make_global_array(mesh8, a) for a in inp["train_batch"])
        losses = []
        for _ in range(3):
            st, metrics = jwt.train_step(st, x, y, m, jvoc, dsp, LR, CLIP)
            losses.append(float(metrics["loss"]))
        xs, ms = (make_global_array(mesh2, a) for a in inp["tf_batch"])
        grad_fn = jax.jit(jax.value_and_grad(jtt.loss_tf, has_aux=True),
                          static_argnums=(3, 4, 6, 7))
        (loss, _), grads = grad_fn(replicate(mesh2, inp["tts_p"]), xs, ms,
                                   jtts, TF_R, jax.random.PRNGKey(9), None,
                                   "scan")
        return {"train_voc": {"losses": losses,
                              "grad_norm": float(metrics["grad_norm"])},
                "train_tf": {"loss": float(loss),
                             "grad_norm": float(optax.global_norm(grads))}}

    def generation():
        mel = inp["gen_mel"]
        wave_len = (GEN_FRAMES - 1) * HOP
        out = {"crossfade": np.asarray(jgs.generate_multi_sharded(
            params, [mel], jvoc, dsp, key, mesh2, target=TARGET,
            overlap=OVERLAP, mu_law=False, tail_fade=False,
            noise=noise("crossfade"))[0])}
        mels_up, aux, _ = jax.jit(jwr.upsample_apply,
                                  static_argnums=(2, 3))(
            params["upsample"], jnp.pad(jnp.asarray(mel),
                                        ((0, 0), (0, 0), (2, 2))), jvoc,
            False)
        for name, target, overlap in (("seam_fused", TARGET, OVERLAP),
                                      ("seam_mat", TARGET_M, OVERLAP_M)):
            mf = jF.fold_with_overlap(mels_up, target, overlap)
            af = jF.fold_with_overlap(aux, target, overlap)
            n = mf.shape[0]
            pad = (-n) % WORLD   # gen_sharded.py:344-352, the noise with it
            nz = tuple(jax.device_put(jnp.pad(
                u, ((0, 0), (0, pad)) + ((0, 0),) * (u.ndim - 2),
                constant_values=0.5), NamedSharding(mesh2, P(None, "data")))
                for u in noise(name))
            mf = jax.device_put(jnp.pad(mf, ((0, pad), (0, 0), (0, 0))), sh)
            af = jax.device_put(jnp.pad(af, ((0, pad), (0, 0), (0, 0))), sh)
            samples, _ = jgs.generate_exact_seam(
                params, mf, af, jvoc, dsp.bits, key, target, overlap,
                seam_passes=2, noise=nz)
            out[name] = np.asarray(jgs.concat_folds(samples[:n], target,
                                                    overlap, wave_len))
        out["multi"] = [np.asarray(w) for w in jgs.generate_multi_sharded(
            params, inp["multi_mels"], jvoc, dsp, key, mesh2, target=TARGET,
            overlap=OVERLAP, noise=noise("multi"))]
        return out

    def serving():
        seqs = [np.asarray(text_to_sequence(t, ("english_cleaners",)))
                for t in TEXTS]
        T = max(len(q) for q in seqs)
        ids = np.stack([np.pad(q, (0, T - len(q))) for q in seqs]
                       + [np.zeros(T, seqs[0].dtype)])  # a pad row: 4 over 2
        lens = np.asarray([len(q) for q in seqs] + [1])
        _, lin, _, nv = jtaco._generate_scan(
            inp["tts_p"], jax.device_put(jnp.asarray(ids), sh), jtts, R,
            STEPS, 80, jax.random.PRNGKey(0),
            text_lens=jax.device_put(jnp.asarray(lens), sh))
        t_valid = [min(int(v) * R, STEPS)
                   for v in np.asarray(nv)[:len(TEXTS)]]
        mels = [jnp.clip((lin[b, :, :min(next((k for k in BUCKETS
                                                if k >= t), STEPS), STEPS)]
                          + 4.0) / 8.0, 0.0, 1.0)
                for b, t in enumerate(t_valid)]
        wavs = jgs.generate_multi_sharded(
            params, mels, jvoc, dsp, key, mesh2, target=TARGET,
            overlap=OVERLAP, tail_fade=False, noise=noise("tts"))
        tts = []
        for w, t, mm in zip(wavs, t_valid, mels):
            valid = max(t - 1, 1) * HOP
            w = np.array(np.asarray(w)[:valid], dtype=np.float32)
            k = min(20 * HOP, valid)
            w[-k:] *= np.linspace(1.0, 0.0, k, dtype=w.dtype)
            tts.append((w, np.asarray(mm)[:, :t]))
        msv = jstream.MultiStreamVocoder(
            params, jvoc, dsp, key, LANES, chunk_frames=CHUNK, mu_law=False,
            use_pallas=False, noise=noise("streams"), mesh=mesh2)
        got = {b: [] for b in range(LANES)}
        for b, mm in enumerate(inp["lane_mels"]):
            msv.feed(b, mm[:, :5], drain=False)
        for res in (msv.poll(),) + tuple(
                msv.feed(b, mm[:, 5:])
                for b, mm in enumerate(inp["lane_mels"])) \
                + tuple(msv.flush(b) for b in range(LANES)):
            for b, yy in res.items():
                got[b].append(np.asarray(yy))
        return {"tts": tts,
                "streams": [np.concatenate(got[b]) for b in range(LANES)]}

    return {**training(), **generation(), **serving()}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """(the two ranks' results, the JAX package's results, the inputs): the
    workers run while the JAX side computes."""
    work = tmp_path_factory.mktemp("mesh")
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = torch_threads.subprocess_env(
            WORLD, MASTER_ADDR="localhost", MASTER_PORT=str(port),
            RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
            PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(rank), "--world",
             str(WORLD), "--dir", str(work)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        _cli_dataset(work / "data")
        (work / "hp.py").write_text(CLI_HP
                                    + f"data_path = {str(work / 'data')!r}\n")
        inp = _inputs()
        with open(work / "inputs.tmp", "wb") as f:
            pickle.dump({k: v for k, v in inp.items()
                         if k not in ("voc_p", "tts_p")}, f)
        os.replace(work / "inputs.tmp", work / "inputs.pkl")
        want = _jax_results(inp)
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
        with open(work / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    solo = {**ranks[0]["solo"], **ranks[1]["solo"]}
    return ranks, solo, want, inp, work


def _same(a, b, path="out"):
    """a and b identical, through dicts, lists and tuples."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _rel(got, want, tol):
    assert abs(got - want) <= tol * abs(want), (got, want)


@pytest.mark.parametrize("case", MESH_CASES)
def test_ranks_agree(cluster, case):
    """Every rank returns the same result: gathered samples, averaged
    losses, replicated parameters."""
    ranks = cluster[0]
    _same(ranks[0]["mesh"][case], ranks[1]["mesh"][case])


def test_vocoder_steps_match_one_process_and_jax(cluster):
    """Three data-parallel steps (psum then clip): the JAX package's
    8-device mesh step and one port process on the whole batch."""
    ranks, solo, want, _, _ = cluster
    got = ranks[0]["mesh"]["train_voc"]
    one = solo["train_voc"]
    for g, o, w in zip(got["losses"], one["losses"],
                       want["train_voc"]["losses"]):
        _rel(g, w, 1e-5)
        _rel(g, o, 1e-5)
    _rel(got["grad_norms"][-1], want["train_voc"]["grad_norm"], 1e-5)
    for g, o in zip(got["grad_norms"], one["grad_norms"]):
        _rel(g, o, 1e-5)
    _params_close(got["params"], one["params"], 3, LR)


def _params_close(got, want, steps, lr):
    """Parameters after ``steps`` Adam steps: 99.9 % of the entries within
    1e-5 and every entry within 2 lr a step. Adam moves a weight by about
    lr * g / (|g| + 1e-8), so where |g| is near that epsilon a
    rounding-level difference of the averaged gradient moves the step by
    up to 2 lr (tests/test_torch_port_train.py)."""
    far = total = 0
    for k, v in want.items():
        d = np.abs(got[k].numpy().astype(np.float64) - v.numpy())
        assert d.max() <= 2 * lr * steps, (k, d.max())
        far += int((d > 1e-5).sum())
        total += d.size
    assert far <= 1e-3 * total, (far, total)


def test_tacotron_step_matches_one_process_and_jax(cluster):
    """A teacher-forcing step on two ranks: the CBHG BatchNorm statistics
    are the whole batch's (per-rank statistics would move the loss)."""
    ranks, solo, want, _, _ = cluster
    got, one = ranks[0]["mesh"]["train_tf"], solo["train_tf"]
    _rel(got["loss"], want["train_tf"]["loss"], 1e-5)
    _rel(got["grad_norm"], want["train_tf"]["grad_norm"], 1e-5)
    _rel(got["loss"], one["loss"], 1e-5)
    _rel(got["grad_norm"], one["grad_norm"], 1e-5)
    _params_close(got["params"], one["params"], 1, TF_LR)


@pytest.mark.parametrize("mode", ["offline", "online"])
def test_af_step_matches_one_process(cluster, mode):
    """An attention-forcing step on two ranks: each loss part (the L1
    output terms, the L1 map term offline, the KL term online, all means
    over equal shards) and the update are the one process's."""
    ranks, solo, _, _, _ = cluster
    got = ranks[0]["mesh"]["train_af"][mode]
    one = solo["train_af"][mode]
    for k in ("loss", "loss_out", "loss_attn", "grad_norm"):
        _rel(got[k], one[k], 1e-5)
    _params_close(got["params"], one["params"], 1, TF_LR)


def test_batchnorm_over_ranks_equals_one_process(cluster):
    ranks, solo, _, _, _ = cluster
    got, one = ranks[0]["mesh"]["batchnorm"], solo["batchnorm"]
    for k in ("y", "dx", "dw", "db", "mean", "var"):
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                   atol=2e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["crossfade", "seam_fused", "seam_mat"])
def test_generate_sharded_matches_one_process_and_jax(cluster, name):
    ranks, solo, want, _, _ = cluster
    got = ranks[0]["mesh"]["serve"][name]
    one = solo["serve"][name]
    assert got.dtype == np.float32 and got.shape == one.shape
    np.testing.assert_allclose(got, one, atol=1e-5)
    np.testing.assert_allclose(got, want[name], atol=2e-3)


def test_generate_sharded_stats_and_counter_hash(cluster):
    """The fold layout of 5 folds over 2 ranks; without injected noise the
    ranks draw, through row0 / B_global, the one-process launch's
    numbers."""
    ranks, solo, _, _, _ = cluster
    stats = ranks[0]["mesh"]["serve"]["crossfade_stats"]
    assert {k: stats[k] for k in ("num_folds", "devices", "pad_folds",
                                  "folds_per_shard", "fold_imbalance")} == {
        "num_folds": 5, "devices": 2, "pad_folds": 1, "folds_per_shard": 3,
        "fold_imbalance": 0.2}
    np.testing.assert_allclose(ranks[0]["mesh"]["serve"]["crossfade_hash"],
                               solo["serve"]["crossfade_hash"], atol=1e-5)


def test_generate_multi_sharded_matches_one_process_and_jax(cluster):
    ranks, solo, want, _, _ = cluster
    got = ranks[0]["mesh"]["serve"]["multi"]
    for g, o, w in zip(got, solo["serve"]["multi"], want["multi"]):
        assert g.shape == o.shape == w.shape
        np.testing.assert_allclose(g, o, atol=1e-5)
        np.testing.assert_allclose(g, w, atol=2e-3)


def test_tts_to_wav_batch_mesh_matches_one_process_and_jax(cluster):
    ranks, solo, want, _, _ = cluster
    got = ranks[0]["mesh"]["serve"]["tts"]
    assert len(got) == len(TEXTS)
    for (wav, mel), (wo, mo), (ww, mw) in zip(got, solo["serve"]["tts"],
                                              want["tts"]):
        assert mel.shape == mo.shape == mw.shape
        np.testing.assert_allclose(mel, mo, atol=1e-5)
        np.testing.assert_allclose(mel, mw, atol=2e-5)
        assert wav.shape == wo.shape == ww.shape
        np.testing.assert_allclose(wav, wo, atol=1e-5)
        np.testing.assert_allclose(wav, ww, atol=2e-3)


def test_multistream_mesh_matches_one_process_and_jax(cluster):
    ranks, solo, want, _, _ = cluster
    got = ranks[0]["mesh"]["serve"]["streams"]
    for b, (g, o, w) in enumerate(zip(got, solo["serve"]["streams"],
                                      want["streams"])):
        assert g.shape == o.shape == w.shape == (LANE_FRAMES[b] * HOP,)
        np.testing.assert_allclose(g, o, atol=1e-5)
        np.testing.assert_allclose(g, w, atol=2e-3)


@pytest.mark.parametrize("model", ["wavernn", "tacotron"])
def test_training_cli_under_torchrun_matches_one_process(cluster, model):
    """``cli.train_<model>`` on two ranks (each its slice of every global
    batch; rank 0 alone writes): the same checkpoints, metrics records and
    losses as the CLI in one process, the weights as ``_params_close``."""
    work = cluster[4]
    sub = "tiny.wavernn" if model == "wavernn" else "tinytts.tacotron"
    runs = [work / run / "checkpoints" / sub for run in ("cli_mesh",
                                                         "cli_solo")]
    names = [sorted(p.name for p in d.iterdir()) for d in runs]
    assert names[0] == names[1] and "latest_weights.npz" in names[0]
    logs = [[json.loads(ln) for ln in (d / "metrics.jsonl").read_text()
             .splitlines()] for d in runs]
    assert [r["event"] for r in logs[0]] == [r["event"] for r in logs[1]]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]
    for a, b in zip(*logs):
        _rel(a["loss"], b["loss"], 1e-5)
    with np.load(runs[0] / "latest_weights.npz") as za, \
            np.load(runs[1] / "latest_weights.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        got = {k: torch.from_numpy(za[k]) for k in za.files}
        want = {k: torch.from_numpy(zb[k]) for k in zb.files}
    lr = 1e-4 if model == "wavernn" else 1e-3
    _params_close(got, want, 3, lr)
    if model == "wavernn":        # rank 0's generated test item only
        outs = list((work / "cli_mesh" / "model_outputs").rglob("*.wav"))
        assert len(outs) == 2


def test_counter_uniforms_rows_are_rows_of_the_full_draw():
    from wavernn_tpu_torch.ops import cuda_gen as cg
    full = cg.counter_uniforms(123, 7, 9, 11, True, "cpu")
    assert torch.equal(full, cg.counter_uniforms(123, 7, 9, 11, True, "cpu",
                                                 row0=0, B_global=9))
    for row0, B in ((0, 4), (4, 5), (3, 3)):
        part = cg.counter_uniforms(123, 7, B, 11, True, "cpu", row0=row0,
                                   B_global=9)
        assert torch.equal(part, full[:, row0:row0 + B])
    raw = cg.counter_uniforms(5, 3, 6, 512, False, "cpu")
    assert torch.equal(raw[:, 2:6], cg.counter_uniforms(
        5, 3, 4, 512, False, "cpu", row0=2, B_global=6))
    with pytest.raises(ValueError, match="row0"):
        cg.counter_uniforms(1, 2, 3, 4, True, "cpu", row0=-1)


def _cli_dataset(root, n_items=12, seed=0):
    """Items that serve both CLIs: mel/, quant/, dataset.pkl and
    text_dict.pkl (14 to 20 frames: a vocoder window of 6 fits)."""
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    (root / "quant").mkdir()
    ids, text = [], {}
    for i in range(n_items):
        name = f"cli{i:03d}"
        frames = int(rng.randint(14, 21))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        np.save(root / "quant" / f"{name}.npy",
                rng.randint(0, 2 ** 16, frames * HOP).astype(np.int64))
        ids.append((name, frames))
        text[name] = TEXTS[i % len(TEXTS)][:10 + 3 * (i % 7)]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def _vocoder_dataset(root, n_items=20, frames=24, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    (root / "quant").mkdir()
    ids = []
    for i in range(n_items):
        name = f"item{i:03d}"
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        np.save(root / "quant" / f"{name}.npy",
                rng.randint(0, 2 ** 16, frames * HOP).astype(np.int64))
        ids.append((name, frames))
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)


def _tts_dataset(root, n_items=18, seed=0):
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True, exist_ok=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"tts{i:03d}"
        frames = int(rng.randint(12, 30))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = TEXTS[i % len(TEXTS)][:10 + 3 * (i % 7)]
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def _same_batches(jb, pb, epochs=2):
    assert len(jb) == len(pb)
    n = 0
    for _ in range(epochs):
        for jbatch, pbatch in zip(jb, pb):
            for a, b in zip(jbatch, pbatch):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert list(a) == list(b)
            n += 1
    assert n == epochs * len(pb) > 0


@pytest.mark.parametrize("shard_index", [0, 1])
def test_batcher_shards_match_jax(tmp_path, shard_index):
    """Each rank's slice of the global batch, over two epochs, bit for bit
    the JAX package's (the crops drawn with the epoch's one rng, the TTS
    batch padded to its longest item before the slice)."""
    from wavernn_tpu.config import Config as JConfig
    from wavernn_tpu.config import TacotronConfig as JTTS
    from wavernn_tpu.config import WaveRNNTrainConfig as JTrain
    from wavernn_tpu.data.dataset import get_tts_datasets as j_tts
    from wavernn_tpu.data.dataset import get_vocoder_datasets as j_voc
    from wavernn_tpu_torch.config import WaveRNNTrainConfig
    from wavernn_tpu_torch.data.dataset import (get_tts_datasets,
                                                get_vocoder_datasets)
    _vocoder_dataset(tmp_path / "voc")
    train = dict(seq_len=2 * HOP, test_samples=4)
    jcfg = JConfig(voc_train=JTrain(**train))
    cfg = Config(voc_train=WaveRNNTrainConfig(**train))
    jb, _ = j_voc(tmp_path / "voc", 4, jcfg, seed=3, num_shards=2,
                  shard_index=shard_index)
    pb, _ = get_vocoder_datasets(tmp_path / "voc", 4, cfg, seed=3,
                                 num_shards=2, shard_index=shard_index)
    _same_batches(jb, pb)
    _tts_dataset(tmp_path / "tts")
    jb, jex = j_tts(tmp_path / "tts", 6, 2, JConfig(tts=JTTS(**TTS)), seed=1,
                    num_shards=2, shard_index=shard_index)
    pb, pex = get_tts_datasets(tmp_path / "tts", 6, 2, _cfg(), seed=1,
                               num_shards=2, shard_index=shard_index)
    assert pex == jex
    _same_batches(jb, pb)
    with pytest.raises(ValueError, match="divide"):
        get_vocoder_datasets(tmp_path / "voc", 5, cfg, num_shards=2)


def test_clip_scales_a_shared_gradient_once():
    """Autograd gives two parameters summed in the forward one gradient
    tensor (Tacotron's b_ih + b_hh into B6): the clip scales it once, so
    the clipped norm is the limit, as optax's is."""
    from wavernn_tpu_torch.train.wavernn_train import (clip_by_global_norm_,
                                                       global_norm)
    a = torch.randn(6, requires_grad=True)
    b = torch.randn(6, requires_grad=True)
    w = torch.randn(3, 6, requires_grad=True)
    y = (w @ (a + b)).pow(2).sum() * 100
    grads = list(torch.autograd.grad(y, [a, b, w]))
    assert grads[0] is grads[1]
    norm = global_norm(grads)
    assert float(norm) > 1.0
    clip_by_global_norm_(grads, norm, 1.0)
    assert abs(float(global_norm(grads)) - 1.0) < 1e-6


def test_mesh_helpers_refuse_what_is_not_a_mesh():
    from wavernn_tpu_torch.parallel import mesh as pm
    from wavernn_tpu_torch.parallel.mesh import FoldShard
    with pytest.raises(TypeError, match="DeviceMesh"):
        FoldShard(4, object())
    one = FoldShard(5)
    x = torch.arange(10.0).reshape(5, 2)
    assert one.take(x, 0) is x and one.rows() == {"row0": 0, "B_global": 5}
    assert one.stats()["pad_folds"] == 0
    assert pm.training_mesh(7) is None        # a single process: no mesh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args()
    worker(a.rank, a.world, Path(a.dir))
