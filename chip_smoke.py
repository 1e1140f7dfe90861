#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wavernn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits nonzero:

  env      the card (nvidia-smi name and power limit), torch and CUDA versions
  build    nvcc builds of every kernel source, in parallel, with their times
  b1       the fused sample-loop kernel against its plain version at full
           width (rnn 512, fc 512), 10 folds over 4 hop-chunks: float32
           weights under injected noise (MOL and RAW; every fold within
           2e-3), bfloat16 weights (at least 99 % of samples within 1e-3,
           statistics), and the production counter-hash noise
  b2       the decode kernel against its plain version at full width
           (decoder 256, lstm 512), ~60 text positions, r=2, 200 groups:
           no stop, and a forced stop (same n_valid, frozen replay)
  main     text -> wav through ``synthesis.tts_to_wav`` at the full default
           Config() with weights made from a seed: stage times, audio
           seconds, real-time factor and both kernels' launch counts
  b5       the GRU recurrence kernels (forward and backward) against their
           plain versions at the training shape T 1375, H 512, at B 32 and
           B 128, float32 (TF32 off) and bfloat16 streams
  train    vocoder training at the full default Config(): a synthetic
           dataset in the reference layout, the CLI entry point
           ``cli.train_wavernn`` run in-process for 6 steps (checkpoint at
           step 5 with a generated test item), B5's launch counts, the
           saved checkpoint generated from again; then one full-width step
           with the kernels against ``recurrence="scan"`` from the same
           weights and batch (loss and every gradient), steps/s, samples/s
           and the stage ms of a step
  timings  each kernel and its plain version at the main path's shapes
           and on its inputs, with CUDA events after warm-up, the least
           time the card could take for the same work, and the outputs
           held against each other (B1 bfloat16 and float32 as in b1, B2
           as in b2, B5 forward and backward in float32 at the train step's
           shape), and cuDNN's ``torch.nn.GRU`` at that shape as B5's
           library yardstick

Then the card's name and power limit, the kernels JSON line, and last the
device line. Comparisons run with TF32 off (cuDNN convolutions default to
TF32). Exits 2 without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor, float32
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

B1_SOURCE = "wavernn_tpu_torch/csrc/sample_loop_fused.cu"
B2_SOURCE = "wavernn_tpu_torch/csrc/taco_decode.cu"
B5_SOURCE = "wavernn_tpu_torch/csrc/gru_seq.cu"
# B5 tolerances. float32: summation order only, over 1375 steps. bfloat16
# streams: ys/sv within a few bf16 ulps at |v| <= 1 (2**-8 each; a one-ulp
# rounding flip of h is carried forward), gradients 3e-2 of the largest
# entry (the JAX package's own bf16 bound is 5e-2)
B5_F32_TOL = 1e-4
B5_BF16_TOL = 3e-2
TRAIN_STEPS = 6


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare_folds(got, want, tol):
    """Agreement of two (B, T) sample trajectories over every fold: (max abs
    error, share of samples within tol, first index beyond tol per fold,
    T where none is)."""
    err = (got - want).abs()
    bad = ~(err <= tol)   # a NaN counts as beyond
    firsts = [int(row.nonzero()[0]) if row.any() else got.shape[1]
              for row in bad]
    return float(err.max()), float((~bad).float().mean()), firsts


def check_b1_f32(tag, got, want, tol):
    """float32 weights on both sides differ by summation order only, so
    every sample of every fold must agree; a fold that took the other
    branch of a Gumbel argmax fails the check."""
    err, share, firsts = compare_folds(got, want, tol)
    res = {f"{tag}_max_abs_err": err, f"{tag}_share_within_tol": share,
           f"{tag}_first_divergence_per_fold": firsts}
    return res, err <= tol


def check_b1_bf16(got, want):
    """bfloat16 matrices against the plain version on the same rounded
    weights in float32 (the kernel accumulates in float32): at least 99 %
    of samples within 1e-3, finite and in [-1, 1]; mean and std within
    0.02, the most that the other 1 % (values in [-1, 1]) can move them."""
    _, share, firsts = compare_folds(got, want, 1e-3)
    res = {"bf16_share_within_1e-3": share,
           "bf16_first_divergence_per_fold": firsts,
           "bf16_mean": [float(got.mean()), float(want.mean())],
           "bf16_std": [float(got.std()), float(want.std())]}
    ok = (share >= 0.99 and bool(got.isfinite().all())
          and float(got.abs().max()) <= 1.0
          and abs(res["bf16_mean"][0] - res["bf16_mean"][1]) <= 0.02
          and abs(res["bf16_std"][0] - res["bf16_std"][1]) <= 0.02)
    return res, ok


def check_b2(got, want, mel_tol, att_tol):
    """Decode kernel against its plain version: n_valid equal, mel and
    attention within their tolerances."""
    (mel_k, att_k, nv_k), (mel_p, att_p, nv_p) = got, want
    res = {"n_valid": [int(nv_k[0]), int(nv_p[0])],
           "mel_max_abs_err": float((mel_k - mel_p).abs().max()),
           "attn_max_abs_err": float((att_k - att_p).abs().max())}
    ok = (res["n_valid"][0] == res["n_valid"][1]
          and res["mel_max_abs_err"] <= mel_tol
          and res["attn_max_abs_err"] <= att_tol)
    return res, ok


def cuda_ms(fn, reps: int):
    """(ms per call of ``fn`` after one warm-up call, the last result)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def step_kernels(fn, names):
    """One call of ``fn`` under torch.profiler (device activity only): its
    kernel count, the ms the device was busy with them (the union of their
    intervals) and the ms of the kernels whose name holds one of
    ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no kernel of the step")
    busy, end = 0.0, -math.inf
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    named = sum(e - s for s, e, n in spans if any(k in n for k in names))
    return {"kernels": len(spans), "busy_ms": busy / 1e3,
            "named_ms": named / 1e3}


def b1_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K, wbytes):
    """(FLOPs, bytes) the fused sample loop needs for these shapes."""
    per_sample = 2 * (2 * 3 * R * R + 2 * 3 * R * R + FC * R + FC * FC
                      + NC * FC)
    per_chunk = 2 * (K * R * n_mels + R * A + 3 * R * A + 2 * FC * A)
    flops = B * T * per_sample + B * fold_chunks * per_chunk
    n_w = (R * (n_mels + A) + 2 * 3 * R * R + 3 * R * (R + A)
           + FC * (R + A) + FC * (FC + A) + NC * FC)
    n_f32 = R + R + 4 * 3 * R + 2 * FC + NC
    frames = (fold_chunks + K - 1) * B * (n_mels + 4 * A)
    nbytes = n_w * wbytes + 4 * (n_f32 + frames + K * (T // fold_chunks)
                                 + B * T)
    return flops, nbytes


def b2_work(groups, T, E, D, P1, P2, L, F, n_mels, n_out_groups):
    """(FLOPs, bytes) the decode needs for ``groups`` computed groups."""
    per_group = 2 * (P1 * n_mels + P2 * P1 + 3 * D * (E + P2) + 3 * D * D
                     + D * D + T * (32 * 62 + D * 32 + D) + E * T
                     + L * (E + D) + 2 * 2 * 4 * L * L + F * L)
    n_w = (P1 * n_mels + P1 + P2 * P1 + P2 + 3 * D * (E + P2) + 3 * D * D
           + 6 * D + D * D + D + 32 * 62 + D * 32 + D + L * (E + D) + L
           + 2 * (8 * L * L + 4 * L) + F * L)
    nbytes = 4 * (n_w + T * (E + D + 1) + n_out_groups * (F + T) + 1)
    return groups * per_group, nbytes


def gru_work(T, B, H, nbytes, backward):
    """(FLOPs, bytes) of one B5 launch: each input read once and each
    output written once; stream elements of ``nbytes`` bytes."""
    flops = 2 * T * B * H * 3 * H
    if backward:   # sv, ys, dys, wh, h0 in; dgi, dgh, dh0 (f32) out
        streams = T * B * (4 * H + H + H + 3 * H + 3 * H)
        return flops, nbytes * (streams + 3 * H * H + B * H) + 4 * B * H
    # gi, wh, h0 in (bh f32); ys, sv out
    return flops, (nbytes * (T * B * (3 * H + H + 4 * H) + 3 * H * H + B * H)
                   + 4 * 3 * H)


def bound(flops, nbytes, peak):
    """(least ms, what sets it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want):
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def gru_inputs(T, B, H, dtype, dev, seed):
    import torch
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g) * scale
    return (rnd(T, B, 3 * H, scale=0.5).to(dtype).to(dev),
            rnd(H, 3 * H, scale=H ** -0.5).to(dtype).to(dev),
            rnd(3 * H, scale=0.05).to(dev),
            rnd(B, H, scale=0.1).to(dtype).to(dev),
            rnd(T, B, H, scale=0.1).to(dtype).to(dev))


def check_b5(cuda_gru, gi, wh, bh, h0, dys):
    """Both B5 kernels against their plain versions on the same inputs
    (the backward on the kernel's own forward streams): (result, ok)."""
    import torch
    bf16 = gi.dtype == torch.bfloat16
    tol = B5_BF16_TOL if bf16 else B5_F32_TOL
    ys, sv = cuda_gru.gru_seq_fwd(gi, wh, bh, h0)
    ys_p, sv_p = cuda_gru.gru_seq_ref(gi, wh, bh, h0)
    dgi, dgh, dh0 = cuda_gru.gru_seq_bwd(sv, ys, wh, h0, dys)
    pdgi, pdgh, pdh0 = cuda_gru.gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    torch.cuda.synchronize()
    res = {"ys_max_abs_err": float((ys.float() - ys_p.float()).abs().max()),
           "sv_max_abs_err": float((sv.float() - sv_p.float()).abs().max()),
           "dgi_rel_err": rel_err(dgi, pdgi), "dgh_rel_err": rel_err(dgh, pdgh),
           "dh0_rel_err": rel_err(dh0, pdh0),
           "bwd_max_abs_err": max(float((a.float() - b.float()).abs().max())
                                  for a, b in ((dgi, pdgi), (dgh, pdgh),
                                               (dh0, pdh0)))}
    ok = (res["ys_max_abs_err"] <= tol and res["sv_max_abs_err"] <= tol
          and max(res["dgi_rel_err"], res["dgh_rel_err"],
                  res["dh0_rel_err"]) <= tol
          and all(bool(t.isfinite().all()) for t in (ys, sv, dgi, dgh, dh0)))
    return res, ok


def write_dataset(root: Path, n_items: int, frames: int, hop: int, seed: int):
    """A synthetic vocoder dataset in the reference layout: dataset.pkl,
    mel/*.npy (80 x frames, uniform in [0, 1]) and quant/*.npy (16-bit
    labels of a noisy sine)."""
    import pickle
    import numpy as np
    rng = np.random.RandomState(seed)
    (root / "mel").mkdir(parents=True)
    (root / "quant").mkdir()
    t = np.arange(frames * hop) / 22050.0
    ids = []
    for i in range(n_items):
        name = f"smoke{i:03d}"
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        wave = (0.5 * np.sin(2 * np.pi * (110 + 7 * i) * t)
                + 0.02 * rng.randn(t.size))
        q = np.clip(np.round((wave + 1) / 2 * (2 ** 16 - 1)), 0, 2 ** 16 - 1)
        np.save(root / "quant" / f"{name}.npy", q.astype(np.int64))
        ids.append((name, frames))
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "wavernn_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(wavernn_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from wavernn_tpu_torch.config import Config, WaveRNNConfig
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import _build, cuda_gen, cuda_gru, cuda_taco
    from wavernn_tpu_torch.ops import layers as L
    from wavernn_tpu_torch.synthesis import tts_to_wav
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.timing import elapsed_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- build ----
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=round(build_s, 3), built=sorted(logs),
         ptxas=ptxas)

    cfg = Config()
    gen = torch.Generator().manual_seed(1234)

    # ---- b1: fused sample loop against its plain version ----
    b1 = {}
    TOL = 2e-3   # float32: summation order only (the JAX package's bound)

    def fail(phase, msg, **res):
        emit(phase, ok=False, **res)
        raise AssertionError(msg)

    for mode in ("MOL", "RAW"):
        voc = wr.WaveRNN(WaveRNNConfig(mode=mode), cfg.dsp)
        voc.reset_parameters(gen)
        voc = voc.to(dev).eval()
        core = voc.core_weights()
        # 30 frames: 10 folds of 1100 samples (4 hop-chunks), the main
        # path's fold count, so the kernel's second, partial tile of
        # folds runs too
        n_fr = 30
        mels = torch.rand(1, 80, n_fr, generator=gen).to(dev)
        target, overlap = 550, 275
        with torch.no_grad():
            frames, phi, geo, chunks = wr.fused_conditioning(
                voc, torch.nn.functional.pad(mels, (2, 2)), n_fr * 275,
                target, overlap)
        B, T = frames.shape[1], chunks * geo.hop
        NC = core["fc3.weight"].shape[0]
        nu = NC // 3 + 1 if mode == "MOL" else NC
        u = cuda_gen.counter_uniforms(99, T, B, nu, mode == "MOL", dev)
        noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
        args = (frames, phi, geo.hop, -geo.d_lo, chunks, mode)
        res = {"folds": B, "steps": T}
        with torch.no_grad():
            got = cuda_gen.generate_fused(core, *args, noise=noise,
                                          compute_dtype=torch.float32)
            ref = cuda_gen.generate_fused_ref(core, *args, noise=noise)
            chk, ok = check_b1_f32("f32_injected", got, ref, TOL)
            res.update(chk)
            if not ok:
                fail("b1", f"B1 {mode}: kernel disagrees with its plain "
                     "version", mode=mode, **res)
            if mode == "MOL":
                got16 = cuda_gen.generate_fused(core, *args, noise=noise)
                ref16 = cuda_gen.generate_fused_ref(
                    cuda_gen.round_core_like_kernel(core), *args,
                    noise=noise)
                chk, ok = check_b1_bf16(got16, ref16)
                res.update(chk)
                if not ok:
                    fail("b1", "B1 bf16 disagrees with its plain version",
                         mode=mode, **res)
                # production noise: the counter hash, in-kernel and in the
                # plain version, from one seed
                gotp = cuda_gen.generate_fused(core, *args, seed=2024,
                                               compute_dtype=torch.float32)
                refp = cuda_gen.generate_fused_ref(core, *args, seed=2024)
                chk, ok = check_b1_f32("prng", gotp, refp, TOL)
                res.update(chk)
                if not ok:
                    fail("b1", "B1 production-noise path disagrees",
                         mode=mode, **res)
        b1[mode] = res
        emit("b1", mode=mode, ok=True, tolerance=TOL, **res)

    # ---- b2: decode against its plain version ----
    tts = taco.Tacotron(cfg.tts, 80)
    tts.reset_parameters(gen)
    tts = tts.to(dev).eval()
    dec = tts.decoder_weights()
    ids = torch.randint(1, 148, (1, 60), generator=gen).to(dev)
    with torch.no_grad():
        enc = tts.encoder(ids)
        encp = L.linear(enc, tts.encoder_proj.weight)
    mask = torch.ones(60, device=dev)
    b2 = {}
    MEL_TOL, ATT_TOL = 2e-3, 2e-4  # float32, 200 groups of recurrence
    for case, thr in (("no_stop", -1e30), ("forced_stop", 10.0)):
        with torch.no_grad():
            got = cuda_taco.decode(dec, enc, encp, mask, 2, 400, 80, 20, thr)
            want = cuda_taco.decode_ref(dec, enc, encp, mask, 2, 400, 80, 20,
                                        thr)
        res, ok = check_b2(got, want, MEL_TOL, ATT_TOL)
        if case == "no_stop":
            ok = ok and res["n_valid"][0] == 200
        else:
            mel_k = got[0]
            frozen = bool(torch.equal(mel_k[..., -4:-2], mel_k[..., -2:]))
            res["replay_frozen"] = frozen
            ok = ok and frozen and res["n_valid"][0] == 7
        b2[case] = res
        emit("b2", case=case, ok=ok, mel_tolerance=MEL_TOL,
             attn_tolerance=ATT_TOL, **res)
        if not ok:
            raise AssertionError(f"B2 {case}: kernel disagrees with its "
                                 "plain version")

    # ---- main: text -> wav at full width ----
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.reset_parameters(gen)
    voc = voc.to(dev).eval()
    text = (ROOT / "test_sentences" / "sentences.txt").read_text() \
        .splitlines()[0].strip()
    r, steps = 2, 400
    tts_to_wav(tts, voc, text, cfg, r, steps=steps,
               generator=torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    cuda_gen.generate_fused.launches = 0
    cuda_taco.decode.launches = 0
    timings = {}
    t0 = time.perf_counter()
    wav, mel, attn = tts_to_wav(tts, voc, text, cfg, r, steps=steps,
                                generator=torch.Generator().manual_seed(1),
                                device=dev, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sample_loop_fused": cuda_gen.generate_fused.launches,
                "taco_decode": cuda_taco.decode.launches}
    audio_s = len(wav) / cfg.dsp.sample_rate
    stages = elapsed_ms(timings)
    import numpy as np
    finite = bool(np.isfinite(wav).all())
    peak = float(np.abs(wav).max())
    emit("main", text=text, text_ids=len(text_to_sequence(
        text, cfg.tts.cleaner_names)), mel_frames=int(mel.shape[1]),
         attn_shape=list(attn.shape), wav_samples=len(wav),
         audio_s=audio_s, wall_s=wall, x_realtime=audio_s / wall,
         stage_ms=stages, launches=launches, wav_finite=finite,
         wav_abs_max=peak)
    # folds' samples lie in [-1, 1]; the equal-power crossfade of two
    # folds can reach sqrt(2)
    if not (finite and peak <= math.sqrt(2) + 1e-9
            and all(launches.values())):
        raise AssertionError("main path: bad wave or a kernel never ran")

    # ---- b5: the GRU recurrence kernels against their plain versions ----
    b5 = {}
    T5, H5 = cfg.voc_train.seq_len, cfg.voc.rnn_dims
    for B5 in (32, 128):
        for dt in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                res, ok = check_b5(cuda_gru, *gru_inputs(T5, B5, H5, dt, dev,
                                                         B5))
            res["plan"] = [cuda_gru.launch_plan(B5, H5, dt, bw)
                           for bw in (False, True)]
            tag = f"B{B5}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            b5[tag] = res
            emit("b5", case=tag, T=T5, H=H5, ok=ok,
                 tolerance=B5_BF16_TOL if dt == torch.bfloat16
                 else B5_F32_TOL, **res)
            if not ok:
                raise AssertionError(f"B5 {tag}: a kernel disagrees with its "
                                     "plain version")

    # ---- train: the vocoder trainer's CLI at full width ----
    import copy
    import os
    import tempfile
    from scipy.io import wavfile
    from wavernn_tpu_torch.cli import train_wavernn
    from wavernn_tpu_torch.cli.common import load_voc_model
    from wavernn_tpu_torch.data.dataset import VocoderBatcher, VocoderDataset
    from wavernn_tpu_torch.data.prefetch import prefetch
    from wavernn_tpu_torch.synthesis import gen_testset
    from wavernn_tpu_torch.train import wavernn_train as wt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data", 40, 120, cfg.dsp.hop_length, 7)
        hp = tmp / "hparams_smoke.py"
        hp.write_text(f"data_path = {str(tmp / 'data')!r}\n"
                      "voc_model_id = 'smoke'\n"
                      f"voc_total_steps = {TRAIN_STEPS}\n"
                      "voc_checkpoint_every = 5\n"
                      "voc_gen_at_checkpoint = 1\nvoc_test_samples = 2\n")
        work = tmp / "run"
        work.mkdir()
        cwd = os.getcwd()
        os.chdir(work)
        cuda_gru.gru_seq_tm.fwd_launches = 0
        cuda_gru.gru_seq_tm.bwd_launches = 0
        t0 = time.perf_counter()
        try:
            train_wavernn.main(["--hp_file", str(hp)])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        cli_s = time.perf_counter() - t0
        b5_launches = {"gru_seq_fwd": cuda_gru.gru_seq_tm.fwd_launches,
                       "gru_seq_bwd": cuda_gru.gru_seq_tm.bwd_launches}
        ckpt = work / "checkpoints" / "smoke.wavernn"
        records = [json.loads(ln) for ln in
                   (ckpt / "metrics.jsonl").read_text().splitlines()]
        epochs = [r for r in records if r["event"] == "epoch"]
        files = {n: (ckpt / n).exists() for n in (
            "latest_weights.npz", "latest_optim.npz",
            "wave_step0K_weights.npz", "wave_step0K_optim.npz")}
        outs = sorted((work / "model_outputs" / "smoke.wavernn").iterdir())
        gen_wavs = [p for p in outs if "gen_batched" in p.name]
        pcm_peak = [int(abs(wavfile.read(p)[1].astype(int)).max())
                    for p in gen_wavs]
        # the named snapshot back from disk, and its test item generated
        # again: the wave itself must be finite (the file is clipped PCM)
        snap, snap_step = load_voc_model(ckpt / "wave_step0K_weights.npz",
                                         cfg, dev)
        test_set = VocoderDataset(tmp / "data", ["smoke000"])
        wav = wr.generate(snap, test_set[0][0][None],
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
        cli = {"steps": [r["step"] for r in epochs],
               "epoch_loss": [r["loss"] for r in epochs],
               "nonfinite_grad_steps": sum(r["nonfinite_grad_steps"]
                                           for r in epochs),
               "nonfinite_loss_steps": sum(r["nonfinite_loss_steps"]
                                           for r in epochs),
               "launches": b5_launches, "files": files,
               "generated": [p.name for p in gen_wavs], "pcm_peak": pcm_peak,
               "snapshot_step": snap_step,
               "regenerated_finite": bool(wav.isfinite().all()),
               "regenerated_samples": int(wav.numel()), "wall_s": cli_s}
        ok = (cli["steps"] == list(range(1, TRAIN_STEPS + 1))
              and all(math.isfinite(v) for v in cli["epoch_loss"])
              and cli["nonfinite_grad_steps"] == 0
              and cli["nonfinite_loss_steps"] == 0
              and b5_launches["gru_seq_fwd"] == 2 * TRAIN_STEPS
              and b5_launches["gru_seq_bwd"] == 2 * TRAIN_STEPS
              and all(files.values()) and len(gen_wavs) == 1
              and pcm_peak[0] > 0 and snap_step == 5
              and cli["regenerated_finite"])
        emit("train", stage="cli", ok=ok, **cli)
        if not ok:
            raise AssertionError("train: the CLI run failed a check")

        # one full-width step, kernels against recurrence="scan", from the
        # same weights and batch
        batcher = VocoderBatcher(VocoderDataset(tmp / "data", [
            f"smoke{i:03d}" for i in range(40)]), cfg,
            cfg.voc_train.batch_size, seed=3)
        t0 = time.perf_counter()
        x, y, m = next(iter(batcher))
        collate_ms = (time.perf_counter() - t0) * 1e3
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        x, y, m = (torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                   for a in (x, y, m))
        end.record()
        state = wt.create_train_state(cfg.voc, cfg.dsp, cfg.voc_train.lr,
                                      cfg.voc_train.clip_grad_norm, seed=11,
                                      device=dev)
        grads = {}
        for rec in ("auto", "scan"):
            loss, g = wt.loss_and_grads(copy.deepcopy(state.model), x, y, m,
                                        cfg.voc, recurrence=rec)
            grads[rec] = (float(loss), g)
        torch.cuda.synchronize()
        h2d_ms = start.elapsed_time(end)
        names = [n for n, _ in state.model.named_parameters()]
        (lk, gk), (ls, gs) = grads["auto"], grads["scan"]
        grad_err = {n: rel_err(a, b) for n, a, b in zip(names, gk, gs)}
        worst = max(grad_err, key=grad_err.get)
        cmp = {"loss_kernels": lk, "loss_scan": ls,
               "loss_rel_err": abs(lk - ls) / abs(ls),
               "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
               "grad_rel_err_gru": {n: grad_err[n] for n in names
                                    if n.startswith("rnn")}}
        ok = (cmp["loss_rel_err"] <= 1e-5 and cmp["grad_max_rel_err"] <= 1e-3
              and math.isfinite(lk))
        emit("train", stage="kernels_vs_scan", ok=ok, loss_tolerance=1e-5,
             grad_tolerance=1e-3, **cmp)
        if not ok:
            raise AssertionError("train: the kernel step disagrees with the "
                                 "scan step")

        # speed of the step and where its time goes
        for _ in range(2):                                   # warm-up
            wt.train_step(state, x, y, m, cfg.voc)
        n_steps = 10
        stage_t = {}
        torch.cuda.synchronize()
        for _ in range(n_steps):
            wt.train_step(state, x, y, m, cfg.voc, timings=stage_t)
        torch.cuda.synchronize()
        stage_ms = {k: v / n_steps for k, v in elapsed_ms(stage_t).items()}
        # host time to enqueue one step (the device drained first), and
        # steps/s on a batch that stays on the card
        host_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wt.train_step(state, x, y, m, cfg.voc)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            wt.train_step(state, x, y, m, cfg.voc)
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        # one step under torch.profiler: its kernels, the time the device
        # was busy with them, and B5's part of it
        device = step_kernels(lambda: wt.train_step(state, x, y, m, cfg.voc),
                              ("gru_fwd", "gru_bwd"))
        device["b5_ms"] = device.pop("named_ms")
        device["idle_share"] = 1 - device["busy_ms"] / (
            1e3 * resident_s / n_steps)

        def loop_s(batches):
            """Seconds of n_steps trainer steps fed through prefetch."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = 0
            for xb, yb, mb in prefetch(batches, device=dev):
                wt.train_step(state, xb, yb, mb, cfg.voc)
                done += 1
                if done == n_steps:
                    break
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        # the trainer's own loop, batches collated from disk by the
        # prefetch thread; then the same loop on batches collated before
        # it starts (the thread only pins them)
        torch.cuda.reset_peak_memory_stats()
        wall = loop_s(iter(lambda: next(iter(batcher)), None))
        t0 = time.perf_counter()
        ready = [next(iter(batcher)) for _ in range(n_steps)]
        collate_mean_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        ready_s = loop_s(ready)
        B_tr = cfg.voc_train.batch_size
        speed = {"steps_per_s": n_steps / wall,
                 "steps_per_s_resident_batch": n_steps / resident_s,
                 "steps_per_s_precollated": n_steps / ready_s,
                 "host_enqueue_ms": min(host_ms), "device": device,
                 "samples_per_s": n_steps * B_tr / wall,
                 "audio_samples_per_s": n_steps * B_tr
                 * cfg.voc_train.seq_len / wall,
                 "step_ms": 1e3 * wall / n_steps,
                 "stage_ms": {**stage_ms, "data_collate_host": collate_ms,
                              "data_collate_host_mean": collate_mean_ms,
                              "data_h2d": h2d_ms},
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "batch": B_tr, "seq_len": cfg.voc_train.seq_len}
        emit("train", stage="speed", **speed)

    # ---- timings at the main path's shapes, each kernel held against its
    # plain version on the same inputs ----
    with torch.no_grad():
        mels = torch.as_tensor(mel)[None].to(dev)   # the vocoder's input
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, torch.nn.functional.pad(mels, (2, 2)),
            mels.shape[-1] * 275, cfg.voc.target, cfg.voc.overlap)
        core = voc.core_weights()
        args = (frames, phi, geo.hop, -geo.d_lo, chunks, cfg.voc.mode)
        B, T = frames.shape[1], chunks * geo.hop
        # as the main path calls it: bfloat16 matrices, counter-hash noise
        b1_ms, got16 = cuda_ms(lambda: cuda_gen.generate_fused(
            core, *args, seed=5), 3)
        # microseconds per sample step at 1, 10 and 32 folds (random
        # frames, 8 hop-chunks): how much of a step is fixed cost
        sweep = {}
        for nb in (1, 10, 32):
            fr = torch.rand(8 + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            sweep[nb] = 1e3 / (8 * geo.hop) * cuda_ms(
                lambda: cuda_gen.generate_fused(core, fr, phi, geo.hop,
                                                -geo.d_lo, 8, cfg.voc.mode,
                                                seed=5), 2)[0]
        # the plain version on the numbers the kernel multiplies (the
        # matrices rounded to bfloat16), same frames and seed
        core16 = cuda_gen.round_core_like_kernel(core)
        b1_plain, ref16 = cuda_ms(lambda: cuda_gen.generate_fused_ref(
            core16, *args, seed=5), 1)
        b1_main, ok16 = check_b1_bf16(got16, ref16)
        # float32 matrices on both sides: every fold within TOL
        got32 = cuda_gen.generate_fused(core, *args, seed=5,
                                        compute_dtype=torch.float32)
        ref32 = cuda_gen.generate_fused_ref(core, *args, seed=5)
        chk, ok32 = check_b1_f32("f32", got32, ref32, TOL)
        b1_main.update(chk)
        R, FC = cfg.voc.rnn_dims, cfg.voc.fc_dims
        fl, by = b1_work(B, T, chunks, R, FC, cfg.voc.aux_dims, 80, 30,
                         geo.K, 2)
        b1_bound = max(fl / PEAK_BF16, by / PEAK_BYTES) * 1e3

        ids = text_to_sequence(text, cfg.tts.cleaner_names)
        x = torch.tensor(ids, device=dev)[None]
        enc = tts.encoder(x)
        encp = L.linear(enc, tts.encoder_proj.weight)
        mask = torch.ones(x.shape[1], device=dev)
        dargs = (dec, enc, encp, mask, r, steps, 80, cfg.tts.max_r,
                 cfg.tts.stop_threshold)
        b2_ms, got = cuda_ms(lambda: cuda_taco.decode(*dargs), 10)
        b2_plain, want = cuda_ms(lambda: cuda_taco.decode_ref(*dargs), 2)
        b2_main, ok2 = check_b2(got, want, MEL_TOL, ATT_TOL)
        n_groups = steps // r
        computed = min(int(got[2][0]) + 1, n_groups)
        fl2, by2 = b2_work(computed, x.shape[1], enc.shape[-1], 256, 256,
                           128, 512, r * 80, 80, n_groups)
        b2_bound = max(fl2 / PEAK_F32, by2 / PEAK_BYTES) * 1e3
        # B5 at the train step's shape (float32 streams, as the default
        # precision runs them), on the same inputs for kernel and plain
        gi, wh, bh, h0, dys = gru_inputs(T5, cfg.voc_train.batch_size, H5,
                                         torch.float32, dev, 5)
        f_ms, (ys, sv) = cuda_ms(lambda: cuda_gru.gru_seq_fwd(gi, wh, bh, h0),
                                 5)
        bw_ms, _ = cuda_ms(lambda: cuda_gru.gru_seq_bwd(sv, ys, wh, h0, dys), 5)
        f_plain, _ = cuda_ms(lambda: cuda_gru.gru_seq_ref(gi, wh, bh, h0), 1)
        bw_plain, _ = cuda_ms(lambda: cuda_gru.gru_seq_bwd_ref(
            sv, ys, wh, h0, dys), 1)
        b5_main, ok5 = check_b5(cuda_gru, gi, wh, bh, h0, dys)
    # cuDNN's GRU at the same shape, input size H: its call also does the
    # input product x @ w_ih^T + b_ih, timed alone and subtracted
    lib_gru = torch.nn.GRU(H5, H5).to(dev)
    xs = torch.randn(T5, cfg.voc_train.batch_size, H5, device=dev,
                     requires_grad=True)
    w_ih, b_ih = lib_gru.weight_ih_l0, lib_gru.bias_ih_l0

    def fwd_bwd(fn):
        def run():
            out = fn()
            out.backward(torch.ones_like(out))
        return run
    with torch.no_grad():
        lib_f, _ = cuda_ms(lambda: lib_gru(xs)[0], 5)
        proj_f, _ = cuda_ms(lambda: torch.addmm(b_ih, xs.view(-1, H5),
                                                w_ih.t()), 5)
    lib_fb, _ = cuda_ms(fwd_bwd(lambda: lib_gru(xs)[0]), 5)
    proj_fb, _ = cuda_ms(fwd_bwd(lambda: torch.addmm(
        b_ih, xs.view(-1, H5), w_ih.t())), 5)
    lib_fwd_ms = lib_f - proj_f
    lib_bwd_ms = (lib_fb - proj_fb) - lib_fwd_ms
    fl5f, by5f = gru_work(T5, cfg.voc_train.batch_size, H5, 4, False)
    fl5b, by5b = gru_work(T5, cfg.voc_train.batch_size, H5, 4, True)
    b5f_bound, b5f_by = bound(fl5f, by5f, PEAK_F32)
    b5b_bound, b5b_by = bound(fl5b, by5b, PEAK_F32)
    ok = ok16 and ok32 and ok2 and ok5
    emit("timings", ok=ok,
         b1={"folds": B, "steps": T, "ms": b1_ms, "plain_ms": b1_plain,
             "bound_ms": b1_bound, "flops": fl, "bytes": by,
             "us_per_step_by_folds": sweep, "check": b1_main},
         b2={"text_len": x.shape[1], "groups_computed": computed,
             "groups": n_groups, "ms": b2_ms, "plain_ms": b2_plain,
             "bound_ms": b2_bound, "flops": fl2, "bytes": by2,
             "check": b2_main},
         b5={"T": T5, "B": cfg.voc_train.batch_size, "H": H5,
             "fwd_ms": f_ms, "bwd_ms": bw_ms, "fwd_plain_ms": f_plain,
             "bwd_plain_ms": bw_plain, "fwd_bound_ms": b5f_bound,
             "bwd_bound_ms": b5b_bound, "fwd_flops": fl5f, "fwd_bytes": by5f,
             "bwd_flops": fl5b, "bwd_bytes": by5b,
             "us_per_step": [1e3 * f_ms / T5, 1e3 * bw_ms / T5],
             "cudnn_fwd_ms": lib_f, "cudnn_fwd_bwd_ms": lib_fb,
             "input_product_fwd_ms": proj_f,
             "input_product_fwd_bwd_ms": proj_fb,
             "library_fwd_ms": lib_fwd_ms, "library_bwd_ms": lib_bwd_ms,
             "check": b5_main})
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the main path's shapes")

    kernels = [
        {"name": "sample_loop_fused", "route": "cuda", "source": B1_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gen.py:673",
         "launches": launches["sample_loop_fused"],
         "max_abs_err": max(b1["MOL"]["f32_injected_max_abs_err"],
                            b1["MOL"]["prng_max_abs_err"],
                            b1_main["f32_max_abs_err"]),
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": "operations" if fl / PEAK_BF16 >= by / PEAK_BYTES
         else "bytes", "library_ms": None},
        {"name": "taco_decode", "route": "cuda", "source": B2_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco.py:74",
         "launches": launches["taco_decode"],
         "max_abs_err": max(b2["no_stop"]["mel_max_abs_err"],
                            b2["forced_stop"]["mel_max_abs_err"],
                            b2_main["mel_max_abs_err"]),
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": "operations" if fl2 / PEAK_F32 >= by2 / PEAK_BYTES
         else "bytes", "library_ms": None},
        {"name": "gru_seq_fwd", "route": "cuda", "source": B5_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:57",
         "launches": b5_launches["gru_seq_fwd"],
         "max_abs_err": max([b5_main["ys_max_abs_err"]]
                            + [r["ys_max_abs_err"] for k, r in b5.items()
                               if k.endswith("f32")]),
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": b5f_bound,
         "bound_by": b5f_by, "library_ms": lib_fwd_ms},
        {"name": "gru_seq_bwd", "route": "cuda", "source": B5_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:122",
         "launches": b5_launches["gru_seq_bwd"],
         "max_abs_err": max([b5_main["bwd_max_abs_err"]]
                            + [r["bwd_max_abs_err"] for k, r in b5.items()
                               if k.endswith("f32")]),
         "ms": bw_ms, "plain_ms": bw_plain, "bound_ms": b5b_bound,
         "bound_by": b5b_by, "library_ms": lib_bwd_ms},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
