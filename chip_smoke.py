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
  timings  each kernel and its plain version at the main path's shapes
           and on its inputs, with CUDA events after warm-up, the least
           time the card could take for the same work, and the outputs
           held against each other (B1 bfloat16 and float32 as in b1, B2
           as in b2)

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
    from wavernn_tpu_torch.ops import _build, cuda_gen, cuda_taco
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
    ok = ok16 and ok32 and ok2
    emit("timings", ok=ok,
         b1={"folds": B, "steps": T, "ms": b1_ms, "plain_ms": b1_plain,
             "bound_ms": b1_bound, "flops": fl, "bytes": by,
             "us_per_step_by_folds": sweep, "check": b1_main},
         b2={"text_len": x.shape[1], "groups_computed": computed,
             "groups": n_groups, "ms": b2_ms, "plain_ms": b2_plain,
             "bound_ms": b2_bound, "flops": fl2, "bytes": by2,
             "check": b2_main})
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
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
