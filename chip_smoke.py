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
  b2       the decode kernel (B2, on the resident decode body csrc/
           taco_decode_resident.cu) against its plain version at full width
           (decoder 256, lstm 512), ~60 text positions, r=2, 200 groups:
           no stop, and a forced stop (same n_valid, frozen replay)
  main     text -> wav through ``synthesis.tts_to_wav`` at the full default
           Config() with weights made from a seed: stage times, audio
           seconds, real-time factor and the kernels' launch counts (B1, B2,
           B5 forward in the CBHG BiGRUs), the postnet with its BiGRU as a
           plain step loop and on B5
  b3       the materialized sample loop (with state I/O) against its plain
           version at full width: float32 at an odd shape (B 3, T 1,000),
           bfloat16 at 10 rows x 2,000 steps (as b1), one launch of 2,000
           steps against two chained launches of 1,000 (identical) and a
           snapshot at step 700 against a 700-step launch's state
  b8       the batched decode (B8, on the resident decode body, one launch
           a batch) against its plain version at full width, r 2,
           200 groups, B 5, 16 and 32 (the five test sentences repeated,
           the length-aware encoder's outputs), no stop; and a forced stop
           at B 32 (random texts, mel_proj as drawn or negated) whose
           threshold, from the plain run's group maxima, stops the rows at
           three or more different groups (n_valid equal, frozen replay)
  b8res    the resident decode body against the plain versions and the
           original body (csrc/taco_decode.cu, ``_legacy=True``): B 1
           through B2's entry point (a 42-symbol test sentence and 60
           random symbols), B 5 and 32 at T_text 43 and B 32 at T_text
           150, each with no stop and a forced stop (mel within 2e-3,
           attention within 2e-4, n_valid equal, the frozen replay bit for
           bit, each body's launch on its own counters); the plan on this
           card; both bodies timed in turns (new, old, old, new), clocks
           read; the per-stage split of a group at B 1 and 32 (clock64() on
           block 0); nvcc's registers and spills of the body's entries (a
           spill fails the phase); the phase's own seconds
  serve    the serving paths at full width, steps 400: tts_to_wav_batch on
           the five sentences, tts_to_wav_fast and tts_to_wav(batched=False)
           on the first, and ``cli.gen_tacotron wavernn --batch_sentences``
           in-process from checkpoints in a temp workspace: wall s, audio s,
           x_realtime, stage ms and exact launch counts per path
  stream   StreamingVocoder over the main path's 400-frame mel, 24-frame
           blocks, injected noise, against one unbatched B3 launch over the
           whole utterance (share of samples within 1e-3 >= 99.9 %), block
           ms; MultiStreamVocoder with 8 lanes fed out of step against their
           solo streams, aggregate x_realtime
  b5       the GRU recurrence kernels (forward and backward, on the
           resident body csrc/gru_resident.cu) against their plain versions
           at the training shape T 1375, H 512, at B 32 and B 128, float32
           (TF32 off) and bfloat16 streams, each launch on the resident body
           and none on the first (csrc/gru_seq.cu)
  b5res    the resident B5 body (thread-block clusters that own batch rows
           and hold the weights, rows exchanged in distributed shared
           memory, no grid barrier) against the plain versions and the first
           body (``_legacy=True``) at the vocoder's shape (B 32 and 128,
           float32 and bfloat16), the CBHG shapes (T 770 and 126, B 32, H
           128), the inference shapes (B 1, T 400 and 42) and two odd shapes,
           within B5_F32_TOL / B5_BF16_TOL; the launch plan on this card and
           the kernel's plan equal to its Python mirror; both bodies timed in
           turns (new, old, old, new) at the vocoder and CBHG shapes (forward
           and backward) and the inference shapes (forward), clocks read,
           with the plain versions, cuDNN's bidirectional GRU less its input
           product and the bound at H 128; nvcc's registers and spills
  train    vocoder training at the full default Config(): a synthetic
           dataset in the reference layout, the CLI entry point
           ``cli.train_wavernn`` run in-process for 6 steps (checkpoint at
           step 5 with a generated test item), B5's launch counts (on the
           resident body, none on the first), the
           saved checkpoint generated from again; then one full-width step
           with the kernels against ``recurrence="scan"`` from the same
           weights and batch (loss and every gradient), steps/s through the
           CLI's and the trainer's own loop and on a resident batch,
           samples/s and the stage ms of a step
  prune    pruned vocoder training at the full default Config(): ``cli.
           train_wavernn --prune`` for 3 steps with the schedule cut to
           reach 93.75 % at step 2, B5's launch counts, the checkpoint's
           (128, 128)-block-dead weights and its pack (14 live blocks in
           the six per-step matrices); then ``cli.gen_wavernn --sparse`` on
           a held-out item, the sparse arm's launch count checked
  b6       the Tacotron teacher-forcing decoder recurrence kernels on the
           resident body (csrc/taco_tf_resident.cu; forward, and backward
           with every weight gradient) against their plain versions: full
           width B 32, T_text 150, 100 groups at r 7; an odd shape B 5,
           T_text 33, 7 groups at r 2; eval mode (zero zoneout masks,
           forward only); float32, TF32 off
  b6res    the resident B6 body against the original body (csrc/
           taco_train.cu's TF arm, ``_legacy=True``) at the b6 full shape:
           every forward output and stream's largest difference (the bit for
           bit ones named), both backwards on the same streams, crossed
           streams (each forward into the other body's backward, against the
           plain backward on them), the original body against the plain
           versions; B 8 and 16 at T_text 150 and B 32 at T_text 200 (r 2,
           200 groups), B 32 over 400 groups at r 2 (800 frames) and the
           AF-online teacher's eval forward (B 32, r 2,
           200 groups, zero zoneout, no streams) against the plain versions;
           both bodies timed in turns (new, old, old, new) at the b6 full
           shape, forward and backward, and at the teacher's shape, forward,
           clocks read; the per-stage split of a group (clock64() on block
           0); nvcc's registers, stack frames and spills of the new entries
           and of B7's four (a spill or a stack frame in taco_tf_res_fwd /
           _bwd fails the phase); the phase's own seconds
  taco_train
           Tacotron training at the full default Config(): a synthetic
           64-item TTS dataset in the reference layout, ``cli.
           train_tacotron`` in-process over a two-session schedule (r 7
           then r 5, 6 steps), B6's and B5's launch counts (every B6 launch
           on the resident body, none on the original), the checkpoint
           pair; ``--force_gta`` and ``--force_attn`` from it (their B6
           launches on the resident body too); one
           full-width step with the kernels against ``recurrence="scan"``
           (same weights, batch and injected masks: the loss within 1e-4;
           each gradient held to a float64 scan step on the float32 step's
           branches at every ReLU, max-pool and L1 term, within 1e-4, or
           twice the float32 scan step's largest distance in its module
           where that is larger); steps/s, stage ms and a profiled step
  b7       the Tacotron attention-forcing decoder recurrence kernels on the
           resident body (csrc/taco_train_resident.cu; forward, and backward
           with d(aref), the prenet's and every other weight gradient)
           against their plain versions: full width B 32, T_text 150, 200
           groups at r 2 (the AF configs' r); the odd shape; eval mode
           (dropout masks of ones, zero zoneout masks, forward only);
           float32, TF32 off
  b7res    the resident B7 body against the original body (csrc/
           taco_train.cu's AF arm, ``_legacy=True``) at the b7 full shape:
           every forward output and stream (the mel chain bit for bit, the
           attention's largest difference), both backwards on the same
           streams, crossed streams (each forward into the other body's
           backward, against the plain backward on them), the original body
           against the plain versions; B 8 and 16 at T_text 150 and B 32
           at T_text 200 against the plain versions; both bodies timed in
           turns (new, old, old, new), forward and backward, clocks read;
           the per-stage split of a group (clock64() on block 0, the
           profiling instantiation); nvcc's registers and spills of the new
           kernels (a spill fails the phase)
  taco_af  inside taco_train's directory, from its TF checkpoint: attention
           references at r 2 (``create_attn_ref`` on B6), ``cli.
           train_tacotron`` in AF-online (the TF checkpoint as the frozen
           teacher, KL x 1.0) and AF-offline (those references, L1 x 200),
           3 steps each at batch 32 warm-started from it: B7's, B6's and
           B5's launch counts (every B7 launch on the resident body, none on
           the original), finite losses and gradient norms, the checkpoint
           pairs; one full-width AF-offline step with the kernels
           against ``recurrence="scan"`` (the batch cut to 400 frames, the
           rule of taco_train's); steps/s and a profiled step of each mode
           with B7's share of device time, and B7's two bodies in turns at
           that batch's shape
  timings  each kernel and its plain version at the main path's shapes
           and on its inputs, with CUDA events after warm-up, the least
           time the card could take for the same work, and the outputs
           held against each other (B1 bfloat16 and float32 as in b1, B2
           as in b2, B5 forward and backward in float32 at the train step's
           shape, B6 and B7 forward and backward at the b6 and b7 full-width
           shapes, B3 at B1's shape and unbatched, B8 at B 5 and 32), and
           cuDNN's ``torch.nn.GRU`` at that shape as B5's library
           yardstick; the SM clock, its maximum and the active clock-limit
           reasons read before and after each timed kernel set
  resident the resident sample-loop body (csrc/sample_loop_resident.cu,
           which every sample loop runs on) against the original body's dense arm
           (``_legacy=True``), bit for bit: B1 at the b1 shape (MOL and
           RAW, float32 and bfloat16, injected noise and the counter hash)
           and the main mel's 10 x 12,100; B4b from a state with a
           snapshot, chained at a chunk boundary; B3 / B4a at 3 x 1,000 and
           10 x 2,000 and two chained launches of 1,000; both bodies timed
           in turns (old, new, new, old) with the clocks read: B1 at 1, 10,
           32 and 50 rows over 8 hop-chunks and at 10 x 12,100, B4b there,
           B3 at 1 and 10 x 12,100, their outputs held equal too; the
           per-stage split of a B1 step at 1 and 10 rows (clock64() on
           block 0); nvcc's registers, shared memory and spills for every
           instantiation of the body (``spills`` lists any)
  sparse   B9, the sparse arm of B1 and B3 on the resident body, on the main
           vocoder's weights pruned at 93.75 % in (128, 128) blocks: bit for
           bit against the original body's sparse arm (``_legacy=True``)
           and the resident dense arm on the same masked weights, at the b1
           shape (bfloat16 and float32), at 1 / 10 / 50 / 128 / 500 rows,
           B3 at one row (both dtypes, chained), a RAW vocoder and the
           allow_br8 (128, 8) blocks (B1 in both dtypes, noise and hash; B3
           at one row), one streaming block against the dense one; against
           its plain version (float32 within 2e-3, bfloat16 as b1); timed
           in turns with the original body's sparse arm (new, old, old,
           new) at the b1 shape, at 1, 10 and 50 rows and B3 at one
           streaming block's 6,600 steps, beside the dense arms' turns,
           clocks read; the per-stage split of a sparse B1 step at 1 and 10
           rows; ``generate_fast`` on the main mel, dense and sparse
  seam     B4b, B1's state arm, and exact-seam generation at the full
           default Config: B4b against its plain version at 10 folds x 4
           hop-chunks from a given state with a snapshot at target +
           overlap (float32 MOL and RAW, every fold and the state within
           2e-3; bfloat16 at least 99 % within 1e-3); one launch against two
           chained at a chunk boundary and a snapshot there against the
           shorter launch's state (bit for bit); the sequential oracle at
           target 11000 / overlap 550 over 3 folds (the fused seam after 2
           passes against one one-row fused launch, the materialized seam
           against one unbatched B3 launch, bit for bit); then
           ``parallel.gen_sharded.generate_sharded(seam_passes=2)`` on the
           main 400-frame mel: wall s, x_realtime, each pass's seam error
           and exact launch counts (3 of B4b, none of B1 or B3), crossfade
           mode and ``generate_fast`` beside it; B4b timed in turns with the
           plain B1 at the b1 shape (B1, B4b, B4b, B1), clocks read around
  b10      B10, the sample loop on pre-projected streams
           (``ops/cuda_gen2.generate_v2``) on the resident body, at the
           full default Config: bit for bit against the original body's arm
           (weights and streams in float32 and bfloat16, MOL and RAW, noise
           and hash, at 10 x 1,100, 1 row and 200 rows); against its plain
           version at 10 rows x 1,100 steps (injected noise, MOL and RAW:
           float32 weights and streams within 2e-3, bfloat16 at least 99 %
           within 1e-3; the counter hash from a seed); its entry point on
           the main mel upsampled and folded, its one launch counted on the
           resident body; its kernel timed in turns with the original
           body's (new, old, old, new) at B3's two shapes (10 x 12,100 and
           1 x 12,100), beside the resident B3, the entry point and the
           stream projections, clocks read around each set; the per-stage
           split of a B10 step at 1 and 10 rows
  mesh     the multi-device paths (parallel/mesh.py) at the full default
           Config, in ranks spawned after the build (torch.multiprocessing):
           (a) one NCCL rank per card (at most 4; one on a one-card
           machine), generate_sharded's DeviceMesh path on the main mel bit
           for bit the one-device call's; (b) two ranks sharing card 0 over
           gloo: generate_sharded on the main mel (10 folds, 5 a rank) in
           crossfade and with seam_passes=2, generate_multi_sharded on the
           five sentences' mels, MultiStreamVocoder with 8 lanes over one
           24-frame block, each bit for bit the one-device call with the same
           seed (the counter hash's global rows, row0 / B_global), every
           rank's launches on the resident bodies; tts_to_wav_batch on the
           five sentences (mels within 2e-3 and n_valid equal: B8 decodes
           each rank's group at its own batch size; waves finite and within
           sqrt(2)); 3 data-parallel vocoder steps at 32 x 1375 and 2
           Tacotron TF steps at batch 32, 16 rows a rank, against one
           process at batch 32 (the losses and the first step's grad norm
           within 1e-4, the later grad norms within 2e-3: DP_TOL), B5's and
           B6's launches a rank and the steps/s of two processes that share
           one card (not a scaling figure); the card's name and power limit
  a12      the analysis side at the full default Config: A12_WAVS seeded
           wavs of 1.5-3 s and a metadata.csv through ``cli.preprocess``,
           ``cli.train_wavernn`` for A12_STEPS steps on that dataset (B5's
           launches on the resident body, none on the first),
           ``cli.gen_wavernn --file`` on one of the wavs (B1 once, the
           target copy written), ``cli.gen_tacotron -a griffinlim --iters
           32 -i`` from a seeded checkpoint (B2 once, B5 forward 4, no
           sample loop, the wav and the attention png written);
           reconstruct_waveform on the card against the port's CPU run with
           the same phase draw on a 400-frame mel (the NNLS within
           A12_NNLS_TOL of its largest magnitude, 4 Griffin-Lim iterations
           from the same magnitude within A12_GL4_TOL of the peak, the
           32-iteration wave within A12_GL_RMS_TOL of its RMS), melspectrogram
           of 10 s on the card against melspectrogram_np (5e-4); the times
           of both inversions (the card's also split into the NNLS and the
           32 iterations) and of the mel, the phase's own seconds

The launch counts of main, serve, stream, prune, sparse, seam, b10 and
mesh (each rank's) show
the resident sample-loop body's launches and none of the original body's;
taco_af's show the resident B7 body's and none of the original's, and
taco_train's and taco_af's (the online teacher, the attention export) the
resident B6 body's and none of the original's; main, serve, b5, timings,
train, prune, taco_train and taco_af the resident B5 body's and none of
the first body's; main, b8 and serve the resident decode body's B2 and B8
launches and none of the original decode body's. Then the card's name and
power limit, the kernels JSON line (twenty-seven kernels: B1, B3, B4b, B9
in B1 and B3, and B10 on the resident body; B1, B3, B4b, B9 and B10 on the
original body, whose times come from the turns; B2 and B8 on the resident
decode body, and on the original with the times from b8res's turns; B5, B6
and B7 forward and backward on their resident bodies, and on their first
bodies with the times from b5res's, b6res's and b7res's turns), and last
the device line. Comparisons run
with TF32 off (cuDNN convolutions default to TF32). Exits 2 without CUDA
or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import re
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
RES_SOURCE = "wavernn_tpu_torch/csrc/sample_loop_resident.cu"
B2_SOURCE = "wavernn_tpu_torch/csrc/taco_decode.cu"
B2RES_SOURCE = "wavernn_tpu_torch/csrc/taco_decode_resident.cu"
B5_SOURCE = "wavernn_tpu_torch/csrc/gru_seq.cu"
B5RES_SOURCE = "wavernn_tpu_torch/csrc/gru_resident.cu"
B6_SOURCE = "wavernn_tpu_torch/csrc/taco_train.cu"
B6RES_SOURCE = "wavernn_tpu_torch/csrc/taco_tf_resident.cu"
B7_SOURCE = "wavernn_tpu_torch/csrc/taco_train_resident.cu"
# B5 tolerances. float32: summation order only, over 1375 steps. bfloat16
# streams: ys/sv within a few bf16 ulps at |v| <= 1 (2**-8 each; a one-ulp
# rounding flip of h is carried forward), gradients 3e-2 of the largest
# entry (the JAX package's own bf16 bound is 5e-2)
B5_F32_TOL = 1e-4
B5_BF16_TOL = 3e-2
# the device kernels of either B5 body, by name (torch.profiler)
B5_KERNELS = ("gru_fwd", "gru_bwd", "gru_res_fwd", "gru_res_bwd")
# b5res: (tag, T, B, H, stream dtype name) - the vocoder's training shape,
# the CBHG BiGRUs in a TF step (postnet 770 frames, encoder 126 symbols),
# at inference (B 1: the 400-frame postnet, the 42-symbol encoder), odd
# shapes (H 203 in clusters of 8 with a short last block; one step of H
# 100 in bfloat16, rows of 200 bytes)
B5RES_SHAPES = (("voc_B32_f32", 1375, 32, 512, "float32"),
                ("voc_B32_bf16", 1375, 32, 512, "bfloat16"),
                ("voc_B128_f32", 1375, 128, 512, "float32"),
                ("voc_B128_bf16", 1375, 128, 512, "bfloat16"),
                ("cbhg_T770", 770, 32, 128, "float32"),
                ("cbhg_T126", 126, 32, 128, "float32"),
                ("infer_T400", 400, 1, 128, "float32"),
                ("infer_T42", 42, 1, 128, "float32"),
                ("odd_H203", 17, 5, 203, "float32"),
                ("odd_H100_T1_bf16", 1, 3, 100, "bfloat16"))
TRAIN_STEPS = 6
# B6 (float32, TF32 off): each output within 1e-4 of its largest entry.
# Kernel and plain version differ in summation order only, but over up to
# 100 dependent groups, with the attention's normalisation and the location
# conv feeding each group's rounding into the next
B6_TOL = 1e-4
B6_FULL = (32, 150, 100, 7)   # B, T_text, groups, r: full width, r = 7
# the AF-online teacher's eval forward: the AF configs' r 2 at 400 frames
B6_TEACHER = (32, 150, 200, 2)
TT_ITEMS = 64
TT_SCHEDULE = ((7, 1e-3, 3, 32), (5, 1e-4, 6, 32))
# B7 (float32, TF32 off): as B6, over 200 groups at r 2, the AF configs' r
B7_FULL = (32, 150, 200, 2)   # B, T_text, groups, r
# the lj_af_online_kl / lj_af_offline schedule's first session, depth cut
# to 3 steps
AF_SCHEDULE = ((2, 1e-3, 3, 32),)
AF_FRAMES = 400               # the kernels-vs-scan and timed AF batch
# B9: the production prune target and blocks; the pruned CLI run's steps
B9_SPARSITY = 0.9375
B9_BLOCK = (128, 128)
PRUNE_STEPS = 3
# a12: the corpus, the vocoder steps on it, the Griffin-Lim mel's frames.
# Griffin-Lim's momentum amplifies float32 rounding: on the CPU the JAX
# package and the port, fed magnitudes 1.3e-5 apart, gave 32-iteration
# waves 0.09-0.75 % of their RMS apart on such a mel; 4 iterations stay
# close, so they hold the card's arithmetic and 32 its drift
A12_WAVS = 40
A12_STEPS = 3
A12_FRAMES = 400
A12_NNLS_TOL = 5e-5
A12_GL4_TOL = 1e-4
A12_GL_RMS_TOL = 3e-2


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_clocks() -> str:
    """The SM clock, its maximum and the active clock-limit reasons (a
    bitmask; 0x0 is none), as nvidia-smi reads them now."""
    err = ""
    for reasons in ("clocks_throttle_reasons.active",
                    "clocks_event_reasons.active"):
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu=clocks.sm,clocks.max.sm,{reasons}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0:
            return out.stdout.strip().splitlines()[0]
        err = (out.stdout + out.stderr).strip()[-200:]
    return f"not read: {err}"


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


def once_ms(fn):
    """(ms of one call of ``fn`` on CUDA events, its result): for the plain
    versions, eager step loops that take seconds and need no warm-up."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def step_kernels(fn, names, top: int = 0):
    """One call of ``fn`` under torch.profiler (device activity only): its
    kernel count, the ms the device was busy with them (the union of their
    intervals), the ms of the kernels whose name holds one of ``names``
    and, when ``top``, the ``top`` kernel names by device ms (name, ms,
    launches)."""
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
    out = {"kernels": len(spans), "busy_ms": busy / 1e3,
           "named_ms": named / 1e3}
    if top:
        by_name = {}
        for s, e, n in spans:
            ms, k = by_name.get(n, (0.0, 0))
            by_name[n] = (ms + (e - s) / 1e3, k + 1)
        out["top"] = [[n[:90], ms, k] for n, (ms, k) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


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


def b4b_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K, wbytes):
    """(FLOPs, bytes) of B1's state arm: B1's work plus the state (h1, h2,
    x) read in and the snapshot written out, float32."""
    flops, nbytes = b1_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K,
                            wbytes)
    return flops, nbytes + 4 * 2 * (2 * B * R + B)


def b10_work(B, T, R, FC, NC, wbytes, sbytes):
    """(FLOPs, bytes) of the pre-projected loop: six products a step (W_h1,
    W_i2x, W_h2, fc1, fc2, fc3); the six matrices in ``wbytes``, the float32
    vectors (w_Ix, wxw1, wxw2, b_h1, b_h2, b_3), the five streams in
    ``sbytes`` (R + 3R + 3R + 2 FC a row-step), each read once, and the
    samples written once."""
    per_sample = 2 * (3 * 3 * R * R + FC * R + FC * FC + NC * FC)
    n_w = 3 * 3 * R * R + FC * R + FC * FC + NC * FC
    nbytes = (n_w * wbytes + 4 * (R + 4 * 3 * R + NC)
              + sbytes * T * B * (7 * R + 2 * FC) + 4 * B * T)
    return B * T * per_sample, nbytes


def b9_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K, wbytes, live,
            n_rows):
    """(FLOPs, bytes) of the fused sample loop's sparse arm: B1's work with
    the six per-step matrices (4 x 3R x R, FC x R, FC x FC) cut to their
    ``live`` (128, 128) blocks, plus the packs' int32 indices (the live
    blocks' columns and ``n_rows`` row pointers)."""
    flops, nbytes = b1_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K,
                            wbytes)
    cut = 4 * 3 * R * R + FC * R + FC * FC - live * 128 * 128
    return (flops - 2 * B * T * cut,
            nbytes - cut * wbytes + 4 * (live + n_rows))


def b9_mat_work(B, T, R, FC, A, n_mels, NC, wbytes, live, n_rows):
    """(FLOPs, bytes) of B3's sparse arm: B3's work with the six per-step
    matrices cut to their ``live`` (128, 128) blocks, plus the packs'
    int32 indices."""
    flops, nbytes = b3_work(B, T, R, FC, A, n_mels, NC, wbytes)
    cut = 4 * 3 * R * R + FC * R + FC * FC - live * 128 * 128
    return (flops - 2 * B * T * cut,
            nbytes - cut * wbytes + 4 * (live + n_rows))


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


def b5_counts():
    """B5's launch counts by body: the resident body's (gru_res_*) and the
    first body's (gru_seq_*_legacy)."""
    from wavernn_tpu_torch.ops import cuda_gru
    tm = cuda_gru.gru_seq_tm
    return {"gru_res_fwd": tm.fwd_launches, "gru_res_bwd": tm.bwd_launches,
            "gru_seq_fwd_legacy": tm.fwd_legacy_launches,
            "gru_seq_bwd_legacy": tm.bwd_legacy_launches}


def zero_b5():
    from wavernn_tpu_torch.ops import cuda_gru
    tm = cuda_gru.gru_seq_tm
    tm.fwd_launches = tm.bwd_launches = 0
    tm.fwd_legacy_launches = tm.bwd_legacy_launches = 0


def b5_on_resident(counts, n_fwd, n_bwd):
    """Whether ``counts`` (b5_counts) hold n_fwd + n_bwd launches of the
    resident body and none of the first body's."""
    return (counts["gru_res_fwd"] == n_fwd and counts["gru_res_bwd"] == n_bwd
            and counts["gru_seq_fwd_legacy"] == 0
            and counts["gru_seq_bwd_legacy"] == 0)


def b5_bodies(g, gi, wh, bh, h0, dys, tol):
    """The resident body, the first body and the plain versions on the same
    inputs, every backward on the resident forward's streams: the errors
    of each body against the plain versions and of the resident body
    against the first (ys and sv absolute, the gradients relative to their
    largest entry), and ``ok``: the resident body finite and within
    ``tol`` of both."""
    import torch
    ys, sv = g.gru_seq_fwd(gi, wh, bh, h0)
    bw = g.gru_seq_bwd(sv, ys, wh, h0, dys)
    ys_l, sv_l = g.gru_seq_fwd(gi, wh, bh, h0, _legacy=True)
    bw_l = g.gru_seq_bwd(sv, ys, wh, h0, dys, _legacy=True)
    ys_p, sv_p = g.gru_seq_ref(gi, wh, bh, h0)
    bw_p = g.gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    torch.cuda.synchronize()

    def maxabs(a, b):
        return float((a.float() - b.float()).abs().max())

    def errs(f, b, f_ref, b_ref):
        out = {"ys_max_abs_err": maxabs(f[0], f_ref[0]),
               "sv_max_abs_err": maxabs(f[1], f_ref[1])}
        for n, a, r in zip(("dgi", "dgh", "dh0"), b, b_ref):
            out[n + "_rel_err"] = rel_err(a, r)
        out["bwd_max_abs_err"] = max(maxabs(a, r) for a, r in zip(b, b_ref))
        return out

    def within(e):
        return (e["ys_max_abs_err"] <= tol and e["sv_max_abs_err"] <= tol
                and max(e["dgi_rel_err"], e["dgh_rel_err"],
                        e["dh0_rel_err"]) <= tol)

    res = {"new_vs_plain": errs((ys, sv), bw, (ys_p, sv_p), bw_p),
           "legacy_vs_plain": errs((ys_l, sv_l), bw_l, (ys_p, sv_p), bw_p),
           "new_vs_legacy": errs((ys, sv), bw, (ys_l, sv_l), bw_l)}
    finite = all(bool(t.isfinite().all()) for t in (ys, sv) + tuple(bw))
    res["ok"] = (finite and within(res["new_vs_plain"])
                 and within(res["new_vs_legacy"]))
    return res


def cudnn_bigru_ms(T, B, H, dev, backward):
    """cuDNN's bidirectional ``torch.nn.GRU(H, H)`` over (T, B, H) less its
    input product (both directions' input weights in one matrix product,
    timed alone): the library's ms for the two recurrences of a BiGRU,
    forward and (``backward``) backward."""
    import torch
    gru = torch.nn.GRU(H, H, bidirectional=True).to(dev)
    xs = torch.randn(T, B, H, device=dev, requires_grad=True)
    w_ih = torch.cat([gru.weight_ih_l0, gru.weight_ih_l0_reverse]).detach(
        ).requires_grad_()
    b_ih = torch.cat([gru.bias_ih_l0, gru.bias_ih_l0_reverse]).detach(
        ).requires_grad_()

    def fwd_bwd(fn):
        def run():
            out = fn()
            out.backward(torch.ones_like(out))
        return run

    def proj():
        return torch.addmm(b_ih, xs.view(-1, H), w_ih.t())
    with torch.no_grad():
        lib_f = cuda_ms(lambda: gru(xs)[0], 5)[0]
        proj_f = cuda_ms(proj, 5)[0]
    out = {"cudnn_bigru_fwd_ms": lib_f, "input_product_fwd_ms": proj_f,
           "library_fwd_ms": lib_f - proj_f}
    if backward:
        lib_fb = cuda_ms(fwd_bwd(lambda: gru(xs)[0]), 5)[0]
        proj_fb = cuda_ms(fwd_bwd(proj), 5)[0]
        out.update(cudnn_bigru_fwd_bwd_ms=lib_fb,
                   input_product_fwd_bwd_ms=proj_fb,
                   library_bwd_ms=(lib_fb - proj_fb) - (lib_f - proj_f))
    return out


def phase_b5res(dev, build_log):
    """B5's resident body (csrc/gru_resident.cu, which every B5 launch runs
    on) against the plain versions and the first body (csrc/gru_seq.cu,
    ``_legacy=True``). At every B5RES_SHAPES shape: both bodies' forwards
    and backwards (each backward on the resident forward's streams)
    against the plain versions, and the resident body against the first,
    within B5_F32_TOL / B5_BF16_TOL (the sums run in other orders, so not
    bit for bit); the launch plan each direction gets on this card; the
    kernel's plan arithmetic equal to its Python mirror
    (``cuda_gru.resident_gru_plan``) over a grid of shapes and card
    figures. Both bodies timed in turns (new, old, old, new), forward and
    backward, at the vocoder's shape and the CBHG shapes (T 770 and 126, B
    32), forward at the inference shapes (B 1, T 400 and 42), the SM clock
    and clock-limit reasons read around each set, with the plain versions'
    ms, cuDNN's bidirectional GRU less its input product and the bound at
    the H 128 shapes. nvcc's registers and spills of every entry. Any miss
    fails the phase; a slower resident body does not. Returns the
    results."""
    import torch
    from wavernn_tpu_torch.ops import cuda_gru as g
    t_phase = time.perf_counter()
    res, oks = {"shapes": {}}, {}
    res["ptxas"], res["spills"] = ptxas_entries(build_log, "gru_res_")
    # 2 stream types x 8 row batches, forward; x 2 output widths, backward
    oks["ptxas_read"] = len(res["ptxas"]) == 48
    zero_b5()
    for i, (tag, T, B, H, dtn) in enumerate(B5RES_SHAPES):
        dt = getattr(torch, dtn)
        tol = B5_BF16_TOL if dt == torch.bfloat16 else B5_F32_TOL
        with torch.no_grad():
            chk = b5_bodies(g, *gru_inputs(T, B, H, dt, dev, 80 + i), tol)
        chk["plan"] = {d: g.resident_launch_plan(B, H, dt, d == "bwd")
                       for d in ("fwd", "bwd")}
        chk.update(T=T, B=B, H=H, dtype=dtn, tolerance=tol)
        res["shapes"][tag] = chk
        oks[tag] = chk["ok"]
    n = len(B5RES_SHAPES)
    res["launches"] = b5_counts()
    oks["launches"] = res["launches"] == {
        "gru_res_fwd": n, "gru_res_bwd": n, "gru_seq_fwd_legacy": n,
        "gru_seq_bwd_legacy": n}
    # the kernel's plan arithmetic against its Python mirror
    bad = []
    for B in (1, 3, 32, 128, 200):
        for H in (64, 100, 128, 203, 512, 1024):
            for bw in (False, True):
                for sms, mc, act in ((132, 16, 0), (132, 16, 7), (132, 8, 0),
                                     (114, 16, 6), (7, 2, 3)):
                    want = g.resident_gru_plan(B, H, torch.float32, bw, sms,
                                               mc, act or None)
                    got = g.resident_plan_c(B, H, bw, sms, mc, act)
                    if got != {k: want[k] for k in g.RES_FIELDS}:
                        bad.append([B, H, bw, sms, mc, act])
    res["plan_mirror_mismatches"] = bad
    oks["plan_mirror"] = not bad
    # both bodies in turns; the plain versions, cuDNN and the bound at H 128
    res["turns"] = {}
    for tag, T, B, H, bwd in (("voc", 1375, 32, 512, True),
                              ("cbhg_T770", 770, 32, 128, True),
                              ("cbhg_T126", 126, 32, 128, True),
                              ("infer_T400", 400, 1, 128, False),
                              ("infer_T42", 42, 1, 128, False)):
        gi, wh, bh, h0, dys = gru_inputs(T, B, H, torch.float32, dev, 90)
        with torch.no_grad():
            ys, sv = g.gru_seq_fwd(gi, wh, bh, h0)
            tt = {"T": T, "B": B, "H": H, "fwd": turns(
                lambda: g.gru_seq_fwd(gi, wh, bh, h0),
                lambda: g.gru_seq_fwd(gi, wh, bh, h0, _legacy=True), 5)}
            if bwd:
                tt["bwd"] = turns(
                    lambda: g.gru_seq_bwd(sv, ys, wh, h0, dys),
                    lambda: g.gru_seq_bwd(sv, ys, wh, h0, dys, _legacy=True),
                    5)
            tt["bound_ms"] = {d: bound(*gru_work(T, B, H, 4, d == "bwd"),
                                       PEAK_F32)[0]
                              for d in (("fwd", "bwd") if bwd else ("fwd",))}
            if H == 128:
                tt["plain_fwd_ms"] = cuda_ms(
                    lambda: g.gru_seq_ref(gi, wh, bh, h0), 1)[0]
                if bwd:
                    tt["plain_bwd_ms"] = cuda_ms(
                        lambda: g.gru_seq_bwd_ref(sv, ys, wh, h0, dys), 1)[0]
        if H == 128:
            tt.update(cudnn_bigru_ms(T, B, H, dev, bwd))
        res["turns"][tag] = tt
    res["new_faster"] = {f"{k}_{d}": v[d]["new_faster"]
                         for k, v in res["turns"].items()
                         for d in ("fwd", "bwd") if d in v}
    res["oks"] = oks
    res["seconds"] = time.perf_counter() - t_phase
    ok = all(oks.values())
    emit("b5res", ok=ok, **res)
    if not ok:
        raise AssertionError("b5res: the resident B5 body failed a check: "
                             + ", ".join(k for k, v in oks.items() if not v))
    return res


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


def write_tts_dataset(root: Path, n_items: int, seed: int):
    """A synthetic TTS dataset in the reference layout: dataset.pkl,
    text_dict.pkl (lines of test_sentences/sentences.txt) and mel/*.npy
    (80 x 300-800 frames, uniform in [0, 1])."""
    import pickle
    import numpy as np
    rng = np.random.RandomState(seed)
    lines = [ln.strip() for ln in (ROOT / "test_sentences" / "sentences.txt")
             .read_text().splitlines() if ln.strip()]
    (root / "mel").mkdir(parents=True)
    ids, text = [], {}
    for i in range(n_items):
        name = f"tts{i:03d}"
        frames = int(rng.randint(300, 801))
        np.save(root / "mel" / f"{name}.npy",
                rng.uniform(0, 1, (80, frames)).astype(np.float32))
        ids.append((name, frames))
        text[name] = " ".join(lines[(i + k) % len(lines)]
                              for k in range(1 + i % 3))
    with open(root / "dataset.pkl", "wb") as f:
        pickle.dump(ids, f)
    with open(root / "text_dict.pkl", "wb") as f:
        pickle.dump(text, f)


def b6_case(B, T, G, r, dev, seed, train=True):
    """B6's inputs at the full default widths: the operands of a seeded
    Tacotron's decoder, encoder outputs, prenet features after dropout,
    zoneout masks (zeros when not ``train``)."""
    import torch
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    cfg = Config()
    gen = torch.Generator().manual_seed(seed)
    model = taco.Tacotron(cfg.tts, 80)
    model.reset_parameters(gen)
    dec = {k: v.detach().to(dev) for k, v in
           model.decoder_parameters().items()}
    weights = ct.decoder_operands(dec, cfg.tts.max_r, r, 80)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    P2, Lh = 128, cfg.tts.lstm_dims
    enc = (0.5 * rnd(B, T, 256)).to(dev)
    encp = (0.5 * rnd(B, T, 256)).to(dev)
    pre = (torch.rand(G, B, P2, generator=gen)
           * (torch.rand(G, B, P2, generator=gen) < 0.5) * 2.0).to(dev)
    if train:
        zm1, zm2 = (torch.rand(2, G, B, Lh, generator=gen) < 0.1).float()
    else:
        zm1 = zm2 = torch.zeros(G, B, Lh)
    return (pre, zm1.to(dev), zm2.to(dev), enc, encp), weights


def check_b6(ct, ins, weights, seed, backward=True, legacy=False):
    """B6's forward kernel against ``core_ref`` (outputs and, when
    ``backward``, every stream), then the backward kernel against
    ``core_bwd_ref`` on the kernel's own streams and random cotangents of
    mel and scores: (result, ok). Relative errors are over each output's
    largest entry. ``legacy``: the original body (csrc/taco_train.cu) in
    place of the resident one."""
    import torch
    mel, sc, st = ct.decoder_tf_fwd(*ins, weights, save=backward,
                                    _legacy=legacy)
    mel_p, sc_p, st_p = ct.core_ref(*ins, *weights, save=backward)
    torch.cuda.synchronize()
    res = {"mel_rel_err": rel_err(mel, mel_p),
           "scores_rel_err": rel_err(sc, sc_p),
           "fwd_max_abs_err": max(float((mel - mel_p).abs().max()),
                                  float((sc - sc_p).abs().max()))}
    fin = [mel, sc]
    errs = [res["mel_rel_err"], res["scores_rel_err"]]
    if backward:
        serr = {k: rel_err(st[k], st_p[k]) for k in ct.STREAMS}
        res["stream_worst"] = max(serr, key=serr.get)
        res["stream_rel_err"] = serr[res["stream_worst"]]
        errs.append(res["stream_rel_err"])
        gen = torch.Generator().manual_seed(seed)
        dmel = torch.randn(mel.shape, generator=gen).to(mel.device)
        dsc = torch.randn(sc.shape, generator=gen).to(mel.device)
        got = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, weights,
                                _legacy=legacy)
        want = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *weights)
        torch.cuda.synchronize()
        names = ("dpre", "denc", "dencp") + ct.WEIGHTS
        gerr = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        res["grad_worst"] = max(gerr, key=gerr.get)
        res["grad_rel_err"] = gerr
        res["bwd_max_abs_err"] = max(float((a - b).abs().max())
                                     for a, b in zip(got, want))
        errs.append(gerr[res["grad_worst"]])
        fin += list(got)
    ok = (max(errs) <= B6_TOL
          and all(bool(t.isfinite().all()) for t in fin))
    return res, ok


def b6_work(G, B, T, E, D, P2, L, F, backward):
    """(FLOPs, bytes) of one B6 launch: each input read once and each
    output written once (float32)."""
    nt = 62
    n_w = (3 * D * (E + P2) + 3 * D * D + 6 * D + D * D + D + nt * D + D
           + L * (E + D) + L + 2 * (8 * L * L + 4 * L) + F * L)
    streams = G * B * (T + 6 * D + 1 + E + 15 * L)
    rec = (3 * D * (E + P2) + 3 * D * D + D * D + L * (E + D) + 16 * L * L
           + F * L)
    inputs = G * B * (P2 + 2 * L) + B * T * (E + D) + n_w
    if not backward:
        flops = 2 * G * B * (rec + T * (nt * D + D) + T * E)
        return flops, 4 * (inputs + G * B * (F + T) + streams)
    flops = 2 * G * B * (2 * rec + 2 * T * E + T * (3 * nt * D + D))
    return flops, 4 * (inputs + streams + G * B * (F + 2 * T)
                       + G * B * P2 + B * T * (E + D) + n_w)


def b7_case(B, T, G, r, dev, seed, train=True):
    """B7's inputs at the full default widths: the AF operands of a seeded
    Tacotron's decoder (prenet first), a reference attention whose rows
    sum to 1, encoder outputs, the prenet's scaled dropout keep-masks and
    zoneout masks (ones and zeros when not ``train``)."""
    import torch
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    cfg = Config()
    gen = torch.Generator().manual_seed(seed)
    model = taco.Tacotron(cfg.tts, 80)
    model.reset_parameters(gen)
    dec = {k: v.detach().to(dev) for k, v in
           model.decoder_parameters().items()}
    weights = ct.af_operands(dec, cfg.tts.max_r, r, 80)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    Lh = cfg.tts.lstm_dims
    aref = torch.rand(G, B, T, generator=gen) ** 4
    aref = aref / aref.sum(-1, keepdim=True)
    enc = 0.5 * rnd(B, T, 256)
    encp = 0.5 * rnd(B, T, 256)
    if train:
        keep = lambda *s: (torch.rand(*s, generator=gen) < 0.5).float() * 2.0
        dm1, dm2 = keep(G, B, 256), keep(G, B, 128)
        zm1, zm2 = (torch.rand(2, G, B, Lh, generator=gen) < 0.1).float()
    else:
        dm1, dm2 = torch.ones(G, B, 256), torch.ones(G, B, 128)
        zm1 = zm2 = torch.zeros(G, B, Lh)
    ins = (aref, dm1, dm2, zm1, zm2, enc, encp)
    return tuple(t.to(dev) for t in ins), weights


def check_b7(ct, ins, weights, seed, backward=True, legacy=False):
    """B7's forward kernel against ``core_af_ref`` (outputs and, when
    ``backward``, every stream), then the backward kernel against
    ``core_af_bwd_ref`` on the kernel's own streams and random cotangents
    of mel and scores: (result, ok). Relative errors are over each
    output's largest entry. ``legacy``: the original body (csrc/
    taco_train.cu) in place of the resident one."""
    import torch
    mel, sc, st = ct.decoder_af_fwd(*ins, weights, save=backward,
                                    _legacy=legacy)
    mel_p, sc_p, st_p = ct.core_af_ref(*ins, *weights, save=backward)
    torch.cuda.synchronize()
    res = {"mel_rel_err": rel_err(mel, mel_p),
           "scores_rel_err": rel_err(sc, sc_p),
           "fwd_max_abs_err": max(float((mel - mel_p).abs().max()),
                                  float((sc - sc_p).abs().max()))}
    fin = [mel, sc]
    errs = [res["mel_rel_err"], res["scores_rel_err"]]
    if backward:
        serr = {k: rel_err(st[k], st_p[k]) for k in ct.AF_STREAMS}
        res["stream_worst"] = max(serr, key=serr.get)
        res["stream_rel_err"] = serr[res["stream_worst"]]
        errs.append(res["stream_rel_err"])
        gen = torch.Generator().manual_seed(seed)
        dmel = torch.randn(mel.shape, generator=gen).to(mel.device)
        dsc = torch.randn(sc.shape, generator=gen).to(mel.device)
        got = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, weights,
                                _legacy=legacy)
        want = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *weights)
        torch.cuda.synchronize()
        names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS
        gerr = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
        res["grad_worst"] = max(gerr, key=gerr.get)
        res["grad_rel_err"] = gerr
        res["bwd_max_abs_err"] = max(float((a - b).abs().max())
                                     for a, b in zip(got, want))
        errs.append(gerr[res["grad_worst"]])
        fin += list(got)
    ok = (max(errs) <= B6_TOL
          and all(bool(t.isfinite().all()) for t in fin))
    return res, ok


def b7_work(G, B, T, E, D, P1, P2, L, F, NM, backward):
    """(FLOPs, bytes) of one B7 launch: each input read once and each
    output written once (float32). The recurrence is B6's with the prenet
    inside (its two layers a group, and their backward) and the context
    contraction's cotangent going to d(aref)."""
    nt = 62
    w_pre = P1 * NM + P1 + P2 * P1 + P2
    n_w = (3 * D * (E + P2) + 3 * D * D + 6 * D + D * D + D + nt * D + D
           + L * (E + D) + L + 2 * (8 * L * L + 4 * L) + F * L) + w_pre
    streams = G * B * (T + 6 * D + 1 + E + 15 * L + NM + P1 + P2)
    rec = (3 * D * (E + P2) + 3 * D * D + D * D + L * (E + D) + 16 * L * L
           + F * L + P1 * NM + P2 * P1)
    # aref, dm1, dm2, zm1, zm2, enc, encp, weights
    inputs = G * B * (T + P1 + P2 + 2 * L) + B * T * (E + D) + n_w
    if not backward:
        flops = 2 * G * B * (rec + T * (nt * D + D) + T * E)
        return flops, 4 * (inputs + G * B * (F + T) + streams)
    flops = 2 * G * B * (2 * rec + 2 * T * E + T * (3 * nt * D + D))
    # + streams, dmel, dsc, scores in; daref, denc, dencp, gradients out
    return flops, 4 * (inputs + streams + G * B * (F + 3 * T)
                       + B * T * (E + D) + n_w)


def branch_mode(replay=None):
    """A torch function mode that records, or with ``replay`` (another
    step's record) takes, the branch of every non-smooth op that
    ``models/tacotron.py`` or this script calls: ``torch.relu`` (x > 0),
    ``torch.maximum`` (a > b, a == b: the CBHG max-pool) and ``torch.abs``
    (the sign: the L1 losses). Replayed, relu is x * mask, maximum routes
    to the recorded side (both halves on a tie, as maximum's gradient
    does) and abs is sign * x, so a float64 step differentiates on the
    float32 step's branches and the two differ by rounding alone. Branches
    inside the decoder recurrence (the AF prenet) are its own. ``flips``
    counts the decisions a replaying step would have taken otherwise."""
    import sys as _sys
    import torch
    from torch.overrides import TorchFunctionMode

    ours = (str(Path("models") / "tacotron.py"), Path(__file__).name)
    kinks = (torch.relu, torch.maximum, torch.abs)

    class Branches(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.taken, self.i, self.flips = [], 0, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in kinks:
                return func(*args, **kwargs)
            f = _sys._getframe(1)
            while f is not None and "/torch/" in f.f_code.co_filename:
                f = f.f_back
            if f is None or not f.f_code.co_filename.endswith(ours):
                return func(*args, **kwargs)
            with torch.no_grad():
                own = ((args[0] > args[1], args[0] == args[1])
                       if func is torch.maximum
                       else (args[0] > 0, args[0] == 0))
            if replay is None:
                self.taken.append((func, own))
                return func(*args, **kwargs)
            fn, (gt, eq) = replay[self.i]
            self.i += 1
            if fn is not func or gt.shape != own[0].shape:
                raise AssertionError("branch replay out of step at "
                                     f"{self.i - 1}: {func} {own[0].shape}")
            self.flips += int((gt != own[0]).sum() + (eq != own[1]).sum())
            x = args[0]
            if func is torch.relu:
                return x * gt.to(x.dtype)
            if func is torch.abs:   # times the sign: 1, 0 or -1
                return x * (2 * gt.to(x.dtype) + eq.to(x.dtype) - 1)
            y = args[1]
            return torch.where(gt, x, torch.where(eq, (x + y) / 2, y))

    return Branches()


def branch_grads(model, x_ids, m, r, recurrence, masks, mode, attn_ref=None,
                 coeff=0.0, replay=None):
    """(loss, gradients as float64 in ``model.parameters()`` order, the
    branch mode) of one Tacotron training step: mean |mel - m| + mean
    |linear - m|, plus ``coeff`` x mean |attn - attn_ref| in AF-offline
    (the trainer's ``loss_tf`` / ``loss_af``), under ``branch_mode``. Of
    some million ReLU inputs, max-pool pairs and L1 terms, a few lie within
    rounding of their kink, and each that rounding turns moves a gradient
    by its Jacobian row: AF float32 steps in five row orders lay 2.4e-3 to
    1.6e-2 from one float64 step on a postnet leaf, and below 1.5e-5 from
    a float64 step on each one's branches (tools/probe_af_check.py)."""
    import torch
    from wavernn_tpu_torch.models import tacotron as taco
    mode_ = branch_mode(replay)
    with mode_:
        mel, linear, attn = taco.forward(model, x_ids, m, r, mode=mode,
                                         training=True,
                                         recurrence=recurrence, masks=masks,
                                         attn_ref=attn_ref)
        loss = torch.mean(torch.abs(mel - m)) + torch.mean(
            torch.abs(linear - m))
        if mode == "attention_forcing_offline":
            loss = loss + coeff * torch.mean(torch.abs(attn - attn_ref))
    if replay is not None and mode_.i != len(replay):
        raise AssertionError(f"branch replay used {mode_.i} of "
                             f"{len(replay)} decisions")
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), [g.double() for g in grads], mode_


def branch_steps(model, steps, mode, r, **kw):
    """``kernels_vs_scan``'s input: ``steps`` maps a tag to (recurrence,
    a function of a dtype giving (x_ids, m, masks, attn_ref) in that step's
    row order); each float32 step, then a float64 plain step on its
    branches."""
    import copy
    import torch
    out, flips = {}, {}
    for tag, (rec, inputs) in steps.items():
        x, m, masks, aref = inputs(torch.float32)
        loss, g, rec32 = branch_grads(copy.deepcopy(model).to(torch.float32),
                                      x, m, r, rec, masks, mode, aref, **kw)
        x, m, masks, aref = inputs(torch.float64)
        _, g64, rec64 = branch_grads(copy.deepcopy(model).to(torch.float64),
                                     x, m, r, "scan", masks, mode, aref,
                                     replay=rec32.taken, **kw)
        out[tag] = (loss, g, g64)
        flips[tag] = rec64.flips
    out["branch_flips"] = flips
    return out


def kernels_vs_scan(out, names):
    """A kernel train step held to the plain one: ``out`` maps "kernels",
    "scan" and optionally "scan_rev" (the batch with its rows reversed: the
    same sums in another order) to (loss, float32 gradients, float64
    gradients), each float64 step on that float32 step's branches
    (``branch_steps``), and "branch_flips" to the count of branches each
    float64 step took from its float32 step against its own. The loss
    within B6_TOL of the float32 scan step's; each gradient within
    max(B6_TOL, twice the largest distance of a float32 plain step from its
    float64 step in the same module) of its float64 step. Returns (result,
    ok)."""
    steps = [t for t in ("kernels", "scan", "scan_rev") if t in out]
    err = {t: {n: rel_err(a, b) for n, a, b in
               zip(names, out[t][1], out[t][2])} for t in steps}
    e_k64 = err["kernels"]
    e_ks = {n: rel_err(a, b) for n, a, b in
            zip(names, out["kernels"][1], out["scan"][1])}
    module = lambda n: n.split(".")[0]
    floor = {}
    for t in steps[1:]:
        for n in names:
            floor[module(n)] = max(floor.get(module(n), 0.0), err[t][n])
    limit = {m: max(B6_TOL, 2 * v) for m, v in floor.items()}
    worst = max(names, key=lambda n: e_k64[n] / limit[module(n)])
    lk, ls = out["kernels"][0], out["scan"][0]
    cmp = {"loss_kernels": lk, "loss_scan": ls,
           "loss_rel_err": abs(lk - ls) / abs(ls),
           "branch_flips": out["branch_flips"],
           "kernels_vs_scan_max": max(e_ks.values()),
           "kernels_vs_scan_median": sorted(e_ks.values())[len(names) // 2],
           "kernels_vs_scan_over_1e-4": sum(v > B6_TOL for v in e_ks.values()),
           "grads": len(names),
           "kernels_vs_f64_max": {m: max(v for n, v in e_k64.items()
                                         if module(n) == m) for m in floor},
           "scan_vs_f64_max": floor, "limit": limit,
           "scan_vs_f64_worst": max(err["scan"], key=err["scan"].get),
           "worst": worst, "worst_vs_f64": e_k64[worst],
           "median_vs_f64": [sorted(err[t].values())[len(names) // 2]
                             for t in ("kernels", "scan")]}
    ok = (cmp["loss_rel_err"] <= B6_TOL and math.isfinite(lk)
          and all(e_k64[n] <= limit[module(n)] for n in names))
    return cmp, ok


SENTENCES = [ln.strip() for ln in (ROOT / "test_sentences" / "sentences.txt")
             .read_text().splitlines() if ln.strip()] \
    if (ROOT / "test_sentences" / "sentences.txt").exists() else []
B8_BATCHES = (5, 16, 32)


def b3_work(B, T, R, FC, A, n_mels, NC, wbytes):
    """(FLOPs, bytes) the materialized sample loop needs: B1's per-sample
    products plus each step's conditioning products, every conditioning
    row read once, the samples written once, the state in and out."""
    per_sample = 2 * (2 * 3 * R * R + 2 * 3 * R * R + FC * R + FC * FC
                      + NC * FC)
    per_row = 2 * (R * (n_mels + A) + 3 * R * A + 2 * FC * A)
    n_w = (R * (n_mels + A) + 2 * 3 * R * R + 3 * R * (R + A)
           + FC * (R + A) + FC * (FC + A) + NC * FC)
    n_f32 = R + R + 4 * 3 * R + 2 * FC + NC
    nbytes = n_w * wbytes + 4 * (n_f32 + T * B * (n_mels + 4 * A) + B * T
                                 + 2 * (2 * B * R + B))
    return B * T * (per_sample + per_row), nbytes


def b8_work(groups, lens, T, E, D, P1, P2, L, F, n_mels, n_groups):
    """(FLOPs, bytes) of the batched decode: each row's groups up to and
    including the one after its stop (its frozen output) at its own text
    length; the weights read once, the padded inputs read and the outputs
    written once."""
    flops = sum(b2_work(g, t, E, D, P1, P2, L, F, n_mels, n_groups)[0]
                for g, t in zip(groups, lens))
    w_bytes = b2_work(0, 0, E, D, P1, P2, L, F, n_mels, 0)[1] - 4
    B = len(lens)
    return flops, (w_bytes + 4 * B * T * (E + D + 1)
                   + 4 * B * n_groups * (F + T) + 4 * B)


def stop_threshold(mel, r):
    """From a decode that never stopped (B, n_mels, steps): the threshold at
    which the most rows stop at distinct groups (row b stops at the first
    group g with g*r > 10 whose largest value is below it), the widest
    margin among equals, the first of equal candidates. Returns (threshold,
    predicted n_valid)."""
    import numpy as np
    B, n_mels, steps = mel.shape
    G = steps // r
    peaks = mel.reshape(B, n_mels, G, r).amax(dim=(1, 3)).double().cpu()
    elig = [g for g in range(G) if g * r > 10]
    vals = np.array(sorted(set(peaks[:, elig].flatten().tolist())))
    thrs = (vals[:-1] + vals[1:]) / 2
    # row b stops at the first eligible group whose peak is below thr: the
    # first index where the peaks' running minimum drops below it
    stops = np.empty((len(thrs), B), np.int64)
    thr32 = thrs.astype(np.float32).astype(np.float64)   # as the kernel compares
    for b in range(B):
        run_min = np.minimum.accumulate(peaks[b, elig].numpy())
        k = np.searchsorted(-run_min, -thr32, side="right")
        stops[:, b] = np.where(k < len(elig),
                               np.asarray(elig + [0])[np.minimum(
                                   k, len(elig))] + 1, G)
    best = None
    for i, thr in enumerate(thrs):
        score = (len(set(stops[i].tolist())), vals[i + 1] - vals[i])
        if best is None or score > best[0]:
            best = (score, float(thr), stops[i].tolist())
    return best[1], best[2]


def check_b8(got, want, mel_tol, att_tol):
    """Batched decode against its plain version: every row's n_valid
    equal, mel and attention within their tolerances."""
    (mel_k, att_k, nv_k), (mel_p, att_p, nv_p) = got, want
    res = {"n_valid": [nv_k.tolist(), nv_p.tolist()],
           "mel_max_abs_err": float((mel_k - mel_p).abs().max()),
           "attn_max_abs_err": float((att_k - att_p).abs().max())}
    ok = (res["n_valid"][0] == res["n_valid"][1]
          and res["mel_max_abs_err"] <= mel_tol
          and res["attn_max_abs_err"] <= att_tol)
    return res, ok


def b8_inputs(tts, seqs, dev):
    """The batched decode's inputs for the id sequences ``seqs`` as the
    serving path makes them: the length-aware encoder on B5, pad positions
    zeroed."""
    import torch
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.ops import layers as L
    ids, lens = taco.pad_ids(seqs, dev)
    with torch.no_grad():
        enc = tts.encoder(ids, engine="kernel", lens=lens)
        mask = (torch.arange(ids.shape[1], device=dev)[None]
                < lens[:, None]).float()
        enc = enc * mask[..., None]
        encp = L.linear(enc, tts.encoder_proj.weight) * mask[..., None]
    return enc, encp, mask, lens.tolist()


def launch_counts():
    """Every kernel's launch count, by kernel name (sample_loop_fused,
    _materialized and _fused_state count B1's, B3's and B4b's launches on
    either body and arm; sample_loop_resident, _resident_mat and
    _resident_state the resident body's dense arms; _resident_sparse and
    _resident_mat_sparse its sparse arms (B9), _resident_v2 its B10;
    sample_loop_old_dense the original body's dense arms, sample_loop_sparse
    its sparse arm and sample_loop_v2 its B10: the yardsticks no serving
    path reaches; taco_decode and taco_decode_batch count B2's and B8's
    launches on the resident decode body, taco_decode_legacy and
    taco_decode_batch_legacy the original decode body's)."""
    from wavernn_tpu_torch.ops import cuda_gen, cuda_gen2, cuda_gru, cuda_taco
    fused, state = cuda_gen.generate_fused, cuda_gen.generate_fused_with_state
    mat, v2 = cuda_gen.generate_materialized, cuda_gen2.generate_v2
    return {"sample_loop_fused": fused.launches,
            "sample_loop_materialized": mat.launches,
            "sample_loop_resident": fused.resident_launches,
            "sample_loop_resident_mat": mat.resident_launches,
            "sample_loop_resident_state": state.resident_launches,
            "sample_loop_resident_sparse": fused.sparse_launches,
            "sample_loop_resident_mat_sparse": mat.sparse_launches,
            "sample_loop_resident_v2": v2.resident_launches,
            "sample_loop_old_dense": (fused.legacy_launches
                                      + state.legacy_launches
                                      + mat.legacy_launches),
            "sample_loop_sparse": (fused.legacy_sparse_launches
                                   + mat.legacy_sparse_launches),
            "sample_loop_fused_state": state.launches,
            "sample_loop_v2": v2.legacy_launches,
            "taco_decode": cuda_taco.decode.launches,
            "taco_decode_batch": cuda_taco.decode_batch.launches,
            "taco_decode_legacy": cuda_taco.decode.legacy_launches,
            "taco_decode_batch_legacy": cuda_taco.decode_batch.legacy_launches,
            "gru_res_fwd": cuda_gru.gru_seq_tm.fwd_launches,
            "gru_seq_fwd_legacy": cuda_gru.gru_seq_tm.fwd_legacy_launches}


def zero_counts():
    from wavernn_tpu_torch.ops import cuda_gen, cuda_gen2, cuda_gru, cuda_taco
    for fn in (cuda_gen.generate_fused, cuda_gen.generate_fused_with_state,
               cuda_gen.generate_materialized, cuda_gen2.generate_v2):
        fn.launches = 0
        fn.resident_launches = 0
        fn.legacy_launches = 0
    for fn in (cuda_gen.generate_fused, cuda_gen.generate_materialized):
        fn.sparse_launches = 0
        fn.legacy_sparse_launches = 0
    for fn in (cuda_taco.decode, cuda_taco.decode_batch):
        fn.launches = 0
        fn.legacy_launches = 0
    cuda_gru.gru_seq_tm.fwd_launches = 0
    cuda_gru.gru_seq_tm.fwd_legacy_launches = 0


def ptxas_entries(log, key):
    """nvcc -Xptxas -v's lines (stack frame and spills, registers) for each
    entry function whose name holds ``key``, and the lines that show a
    spill."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1) if key in m.group(1) else None
            if cur:
                out[cur] = []
        elif cur and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.split("info    : ")[-1].strip())
    spills = [f"{k}: {v}" for k, vs in out.items() for v in vs
              if re.search(r"\b[1-9]\d* bytes spill", v)]
    return out, spills


def tf_counts(ct):
    """B6's launches: in all, and on each body."""
    tf = ct.decoder_tf
    return {"taco_tf_fwd": tf.fwd_launches, "taco_tf_bwd": tf.bwd_launches,
            "taco_tf_res_fwd": tf.resident_fwd_launches,
            "taco_tf_res_bwd": tf.resident_bwd_launches,
            "taco_tf_legacy_fwd": tf.legacy_fwd_launches,
            "taco_tf_legacy_bwd": tf.legacy_bwd_launches}


def zero_tf_counts(ct):
    for k in ("fwd_launches", "bwd_launches", "resident_fwd_launches",
              "resident_bwd_launches", "legacy_fwd_launches",
              "legacy_bwd_launches"):
        setattr(ct.decoder_tf, k, 0)


def on_resident(got, fwd, bwd):
    """Every B6 launch of a run on the resident body: ``fwd`` and ``bwd``
    of them, none on the original body."""
    return (got["taco_tf_fwd"] == got["taco_tf_res_fwd"] == fwd
            and got["taco_tf_bwd"] == got["taco_tf_res_bwd"] == bwd
            and got["taco_tf_legacy_fwd"] == got["taco_tf_legacy_bwd"] == 0)


def phase_b6res(ct, dev, logs):
    """B6's resident body (csrc/taco_tf_resident.cu, which every TF launch
    runs on) against the original body (``_legacy=True``) and the plain
    versions. At the b6 full shape: every forward output and stream of the
    two bodies compared (largest difference; the bit-for-bit ones named:
    the GRU's input product and the context are summed in other orders, so
    no stream need stay bit for bit), and both backwards on the same
    streams; the original body against the plain versions (its kernels-line
    errors); crossed streams, the new forward's into the original backward
    and the original forward's into the new backward, each against the
    plain backward on those streams, within B6_TOL. B 8 and 16 at T_text 150
    and B 32 at T_text 200 (r 2, 200 groups), B 32 over 400 groups at r 2
    (the schedule's 800 frames), and the AF-online teacher's
    eval forward (B6_TEACHER, zero zoneout, no streams), each held to the
    plain versions. Both bodies timed in turns (new, old, old, new):
    forward and backward at the full shape, the teacher's forward, the SM
    clock and clock-limit reasons read around each set. The per-stage split
    of a group from the profiling instantiation (clock64() on block 0,
    cycles a group). nvcc's registers, stack frames and spills for the new
    kernels and B7's four (a spill in any non-profiling entry, or a stack
    frame in taco_tf_res_fwd / _bwd, fails the phase). Returns the
    results."""
    import torch
    t_phase = time.perf_counter()
    res, oks = {}, {}
    ptx, spills = ptxas_entries(logs.get("taco_tf_resident", ""),
                                "taco_tf_res_")
    ptx7, spills7 = ptxas_entries(logs.get("taco_train_resident", ""),
                                  "taco_af_res")
    res["ptxas"], res["spills"] = {**ptx, **ptx7}, spills + spills7
    frames = [f"{k}: {ln}" for k, v in ptx.items() if "_prof" not in k
              for ln in v if re.search(r"\b[1-9]\d* bytes stack frame", ln)]
    res["stack_frames"] = frames
    oks["ptxas_read"] = len(ptx) == 4 and len(ptx7) == 4
    oks["no_spill"] = not [ln for ln in spills + spills7 if "_prof" not in ln]
    oks["no_stack_frame"] = not frames
    Bf, Tf, Gf, rf = B6_FULL
    ins, w = b6_case(Bf, Tf, Gf, rf, dev, 61, True)
    names = ("dpre", "denc", "dencp") + ct.WEIGHTS

    def diff(a, b):
        return 0.0 if torch.equal(a, b) else float((a - b).abs().max())

    with torch.no_grad():
        mel, sc, st = ct.decoder_tf_fwd(*ins, w, save=True)
        mel_o, sc_o, st_o = ct.decoder_tf_fwd(*ins, w, save=True,
                                              _legacy=True)
        fwd_diff = {"mel": diff(mel, mel_o), "scores": diff(sc, sc_o),
                    **{k: diff(st[k], st_o[k]) for k in ct.STREAMS}}
        res["fwd_max_abs_diff_vs_legacy"] = fwd_diff
        res["fwd_bit_for_bit"] = [k for k, v in fwd_diff.items() if v == 0.0]
        g = torch.Generator().manual_seed(62)
        dmel = torch.randn(mel.shape, generator=g).to(dev)
        dsc = torch.randn(sc.shape, generator=g).to(dev)
        new_b = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w)
        old_b = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w, _legacy=True)
        bwd_diff = {n: diff(a, b) for n, a, b in zip(names, new_b, old_b)}
        res["bwd_max_abs_diff_vs_legacy"] = bwd_diff
        res["bwd_bit_for_bit"] = [k for k, v in bwd_diff.items() if v == 0.0]
        # crossed streams, each against the plain backward on them
        ref = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        cross_o = ct.decoder_tf_bwd(dmel, dsc, st_o, sc_o, *ins, w)
        ref_o = ct.core_bwd_ref(dmel, dsc, st_o, sc_o, *ins, *w)
        torch.cuda.synchronize()
        cross = {"new_fwd_into_legacy_bwd": max(
                     rel_err(a, b) for a, b in zip(old_b, ref)),
                 "legacy_fwd_into_new_bwd": max(
                     rel_err(a, b) for a, b in zip(cross_o, ref_o)),
                 "new_fwd_into_new_bwd": max(
                     rel_err(a, b) for a, b in zip(new_b, ref))}
        res["crossed_rel_err"] = cross
        oks["crossed"] = (max(cross.values()) <= B6_TOL and all(
            bool(t.isfinite().all())
            for t in list(old_b) + list(cross_o) + list(new_b)))
        # the original body against the plain versions (its errors)
        chk, oks["legacy_vs_plain"] = check_b6(ct, ins, w, 63, legacy=True)
        res["legacy_vs_plain"] = {k: v for k, v in chk.items()
                                  if k != "grad_rel_err"}
        # other shapes, each held to the plain versions
        res["shapes"] = {}
        for tag, shape, train in (("B8_T150", (8, 150, 200, 2), True),
                                  ("B16_T150", (16, 150, 200, 2), True),
                                  ("B32_T200", (32, 200, 200, 2), True),
                                  ("B32_G400", (32, 150, 400, 2), True),
                                  ("teacher_eval", B6_TEACHER, False)):
            i2, w2 = b6_case(*shape, dev, 64, train)
            chk, oks[tag] = check_b6(ct, i2, w2, 65, backward=train)
            res["shapes"][tag] = {k: v for k, v in chk.items()
                                  if k != "grad_rel_err"}
        # both bodies in turns
        it, wt = b6_case(*B6_TEACHER, dev, 66, False)
        res["turns"] = {
            "fwd": turns(lambda: ct.decoder_tf_fwd(*ins, w, save=True),
                         lambda: ct.decoder_tf_fwd(*ins, w, save=True,
                                                   _legacy=True), 3),
            "bwd": turns(lambda: ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins,
                                                   w),
                         lambda: ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins,
                                                   w, _legacy=True), 3),
            "teacher_fwd": turns(
                lambda: ct.decoder_tf_fwd(*it, wt, save=False),
                lambda: ct.decoder_tf_fwd(*it, wt, save=False, _legacy=True),
                3)}
        oks["new_faster"] = all(t["new_faster"] for t in
                                res["turns"].values())
        # the per-stage split of a group on the new body
        clk = [gpu_clocks()]
        split = {}
        for d_, labels, sub, fn in (
                ("fwd", ct.RES_PROF_TF_FWD, ct.RES_PROF_TF_FWD_ITEMS,
                 lambda pr: ct.decoder_tf_fwd(*ins, w, save=True,
                                              _profile=pr)),
                ("bwd", ct.RES_PROF_TF_BWD, ct.RES_PROF_TF_BWD_ITEMS,
                 lambda pr: ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w,
                                              _profile=pr))):
            prof = torch.zeros(64, dtype=torch.int64, device=dev)
            fn(prof)
            cyc = prof.cpu().tolist()
            split[d_] = {k: cyc[i] / Gf for i, k in enumerate(labels)}
            split[d_]["total"] = sum(split[d_].values())
            # block 0's items, inside the stages above
            split[d_ + "_items"] = {k: cyc[16 + i] / Gf
                                    for i, k in enumerate(sub)}
        clk.append(gpu_clocks())
        res["split_cycles_per_group"], res["split_clocks"] = split, clk
    res["oks"] = oks
    res["seconds"] = time.perf_counter() - t_phase
    ok = all(oks.values())
    emit("b6res", ok=ok, tolerance=B6_TOL, B=Bf, T_text=Tf, G=Gf, r=rf,
         **res)
    if not ok:
        raise AssertionError("b6res: the resident B6 body failed a check: "
                             + ", ".join(k for k, v in oks.items() if not v))
    return res


def phase_b7res(ct, dev, build_log):
    """B7's resident body (csrc/taco_train_resident.cu, which every AF
    training path runs on) against the original body (``_legacy=True``)
    and the plain versions. At the b7 full shape: every forward output and
    stream of the two bodies compared (the mel chain's bit for bit, the
    attention's by its largest difference: the normaliser is summed in
    another order), and both backwards on the same streams; the original
    body against the plain versions (its kernels-line errors); crossed
    streams, the new forward's into the original backward and the original
    forward's into the new backward, each against the plain backward on
    those streams, within B6_TOL. Odd shapes: B 8 and 16 at T_text 150 and
    B 32 at T_text 200, each held to the plain versions. Both bodies timed
    in turns (new, old, old, new), forward and backward, the SM clock and
    clock-limit reasons read around each set. The per-stage split of a
    group from the profiling instantiation (clock64() on block 0, cycles a
    group). nvcc's registers and spills for the new kernels (a spill in
    taco_af_res_fwd or taco_af_res_bwd fails the phase). Returns the
    results."""
    import torch
    res, oks = {}, {}
    ptx, spills = ptxas_entries(build_log, "taco_af_res")
    res["ptxas"], res["spills"] = ptx, spills
    oks["no_spill"] = not [ln for ln in spills if "_prof" not in ln]
    Bf, Tf, Gf, rf = B7_FULL
    ins, w = b7_case(Bf, Tf, Gf, rf, dev, 51, True)
    names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS

    def diff(a, b):
        return 0.0 if torch.equal(a, b) else float((a - b).abs().max())

    with torch.no_grad():
        mel, sc, st = ct.decoder_af_fwd(*ins, w, save=True)
        mel_o, sc_o, st_o = ct.decoder_af_fwd(*ins, w, save=True,
                                              _legacy=True)
        fwd_diff = {"mel": diff(mel, mel_o), "scores": diff(sc, sc_o),
                    **{k: diff(st[k], st_o[k]) for k in ct.AF_STREAMS}}
        # the mel chain keeps the original's sums: bit for bit; the
        # attention's outputs differ by the normaliser's order
        chain = [k for k in fwd_diff if k not in ("scores", "cum", "div")]
        res["fwd_max_abs_diff_vs_legacy"] = fwd_diff
        res["fwd_chain_bit_for_bit"] = all(fwd_diff[k] == 0.0 for k in chain)
        oks["fwd_chain_bit_for_bit"] = res["fwd_chain_bit_for_bit"]
        g = torch.Generator().manual_seed(52)
        dmel = torch.randn(mel.shape, generator=g).to(dev)
        dsc = torch.randn(sc.shape, generator=g).to(dev)
        new_b = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w)
        old_b = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w, _legacy=True)
        res["bwd_max_abs_diff_vs_legacy"] = {
            n: diff(a, b) for n, a, b in zip(names, new_b, old_b)}
        # crossed streams, each against the plain backward on them
        ref = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        cross_o = ct.decoder_af_bwd(dmel, dsc, st_o, sc_o, *ins, w)
        ref_o = ct.core_af_bwd_ref(dmel, dsc, st_o, sc_o, *ins, *w)
        torch.cuda.synchronize()
        cross = {"new_fwd_into_legacy_bwd": max(
                     rel_err(a, b) for a, b in zip(old_b, ref)),
                 "legacy_fwd_into_new_bwd": max(
                     rel_err(a, b) for a, b in zip(cross_o, ref_o))}
        res["crossed_rel_err"] = cross
        oks["crossed"] = (max(cross.values()) <= B6_TOL and all(
            bool(t.isfinite().all()) for t in list(old_b) + list(cross_o)))
        # the original body against the plain versions (its errors)
        chk, oks["legacy_vs_plain"] = check_b7(ct, ins, w, 53, legacy=True)
        res["legacy_vs_plain"] = {k: v for k, v in chk.items()
                                  if k != "grad_rel_err"}
        # odd shapes, each held to the plain versions
        res["shapes"] = {}
        for tag, shape in (("B8_T150", (8, 150, Gf, rf)),
                           ("B16_T150", (16, 150, Gf, rf)),
                           ("B32_T200", (32, 200, Gf, rf))):
            i2, w2 = b7_case(*shape, dev, 54, True)
            chk, oks[tag] = check_b7(ct, i2, w2, 55)
            res["shapes"][tag] = {k: v for k, v in chk.items()
                                  if k != "grad_rel_err"}
        # both bodies in turns, forward and backward
        res["turns"] = {
            "fwd": turns(lambda: ct.decoder_af_fwd(*ins, w, save=True),
                         lambda: ct.decoder_af_fwd(*ins, w, save=True,
                                                   _legacy=True), 3),
            "bwd": turns(lambda: ct.decoder_af_bwd(dmel, dsc, st, sc, *ins,
                                                   w),
                         lambda: ct.decoder_af_bwd(dmel, dsc, st, sc, *ins,
                                                   w, _legacy=True), 3)}
        oks["new_faster"] = all(t["new_faster"] for t in
                                res["turns"].values())
        # the per-stage split of a group on the new body
        clk = [gpu_clocks()]
        split = {}
        for d_, labels, fn in (
                ("fwd", ct.RES_PROF_FWD,
                 lambda pr: ct.decoder_af_fwd(*ins, w, save=True,
                                              _profile=pr)),
                ("bwd", ct.RES_PROF_BWD,
                 lambda pr: ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w,
                                              _profile=pr))):
            prof = torch.zeros(64, dtype=torch.int64, device=dev)
            fn(prof)
            cyc = prof.cpu().tolist()
            split[d_] = {k: cyc[i] / Gf for i, k in enumerate(labels)}
            split[d_]["total"] = sum(split[d_].values())
        clk.append(gpu_clocks())
        res["split_cycles_per_group"], res["split_clocks"] = split, clk
    res["oks"] = oks
    ok = all(oks.values())
    emit("b7res", ok=ok, tolerance=B6_TOL, B=Bf, T_text=Tf, G=Gf, r=rf,
         **res)
    if not ok:
        raise AssertionError("b7res: the resident B7 body failed a check: "
                             + ", ".join(k for k, v in oks.items() if not v))
    return res


def phase_b3(cfg, dev, gen, tol):
    """B3 against its plain version: float32 at an odd shape, bfloat16 at
    full width, and the state handoff. Returns the result dict."""
    import torch
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import cuda_gen as cg
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.reset_parameters(gen)
    voc = voc.to(dev).eval()
    core = voc.core_weights()
    A4 = 4 * cfg.voc.aux_dims
    f32 = torch.float32

    def case(B, T, seed):
        g = torch.Generator().manual_seed(seed)
        mu = torch.rand(B, T, 80, generator=g).to(dev)
        au = (torch.rand(B, T, A4, generator=g) * 2 - 1).to(dev)
        u = cg.counter_uniforms(seed, T, B, 11, True, dev)
        return mu, au, (u[..., :10], u[..., 10])

    def cut(n, a, b):
        return tuple(v[a:b] for v in n)

    res = {}
    with torch.no_grad():
        mu, au, noise = case(3, 1000, 41)
        got, st = cg.generate_materialized(core, mu, au, "MOL", noise=noise,
                                           compute_dtype=f32)
        ref, st_p = cg.generate_materialized_ref(core, mu, au, "MOL",
                                                 noise=noise)
        chk, ok32 = check_b1_f32("f32_odd", got, ref, tol)
        res.update(chk)
        res["f32_odd_state_max_abs_err"] = max(
            float((a - b).abs().max()) for a, b in zip(st, st_p))
        mu, au, noise = case(10, 2000, 42)
        got16, _ = cg.generate_materialized(core, mu, au, "MOL", seed=43)
        ref16, _ = cg.generate_materialized_ref(
            cg.round_core_like_kernel(core), mu, au, "MOL", seed=43)
        chk, ok16 = check_b1_bf16(got16, ref16)
        res.update(chk)
        y, st = cg.generate_materialized(core, mu, au, "MOL", noise=noise,
                                         compute_dtype=f32)
        y1, st1 = cg.generate_materialized(
            core, mu[:, :1000], au[:, :1000], "MOL",
            noise=cut(noise, 0, 1000), compute_dtype=f32)
        y2, st2 = cg.generate_materialized(
            core, mu[:, 1000:], au[:, 1000:], "MOL",
            noise=cut(noise, 1000, 2000), init_state=st1, compute_dtype=f32)
        _, snap = cg.generate_materialized(core, mu, au, "MOL", noise=noise,
                                           state_snapshot_at=700,
                                           compute_dtype=f32)
        _, st700 = cg.generate_materialized(
            core, mu[:, :700], au[:, :700], "MOL", noise=cut(noise, 0, 700),
            compute_dtype=f32)
    torch.cuda.synchronize()
    res["chained_equal_one_launch"] = bool(
        torch.equal(torch.cat([y1, y2], dim=1), y)
        and all(torch.equal(a, b) for a, b in zip(st2, st)))
    res["snapshot_700_equal_700_steps"] = all(
        torch.equal(a, b) for a, b in zip(snap, st700))
    ok = (ok32 and ok16 and res["chained_equal_one_launch"]
          and res["snapshot_700_equal_700_steps"]
          and res["f32_odd_state_max_abs_err"] <= tol)
    emit("b3", ok=ok, tolerance=tol, odd_shape=[3, 1000],
         bf16_shape=[10, 2000], **res)
    if not ok:
        raise AssertionError("B3: the kernel disagrees with its plain version "
                             "or its state handoff is not exact")
    return res


def phase_b8(cfg, dev, tts, mel_tol, att_tol):
    """B8 against its plain version at full width, r 2, 200 groups, B 5,
    16, 32 (the five test sentences, repeated), no stop; then a forced stop
    with the rows stopping at different groups. Returns (results, the no-stop
    cases' inputs and plain outputs by B)."""
    import torch
    from wavernn_tpu_torch.ops import cuda_taco as ctd
    from wavernn_tpu_torch.text import text_to_sequence
    dec = tts.decoder_weights()
    res, cases = {}, {}
    for B in B8_BATCHES:
        enc, encp, mask, lens = b8_inputs(tts, [text_to_sequence(
            SENTENCES[i % len(SENTENCES)], cfg.tts.cleaner_names)
            for i in range(B)], dev)
        args = (dec, enc, encp, mask, 2, 400, 80, cfg.tts.max_r)
        zero_counts()
        with torch.no_grad():
            got = ctd.decode_batch(*args, -1e30)
            want = ctd.decode_batch_ref(*args, -1e30)
        chk, ok = check_b8(got, want, mel_tol, att_tol)
        c = launch_counts()
        chk["launches"] = {k: c[k] for k in ("taco_decode_batch",
                                              "taco_decode_batch_legacy")}
        ok = (ok and chk["n_valid"][0] == [200] * B
              and chk["launches"] == {"taco_decode_batch": 1,
                                      "taco_decode_batch_legacy": 0})
        res[f"B{B}"] = chk
        cases[B] = (args, lens, want)
        emit("b8", case=f"B{B}_no_stop", B=B, T_text=enc.shape[1], ok=ok,
             mel_tolerance=mel_tol, attn_tolerance=att_tol,
             **{k: v for k, v in chk.items() if k != "n_valid"},
             n_valid_equal=chk["n_valid"][0] == chk["n_valid"][1])
        if not ok:
            raise AssertionError(f"B8 B={B}: kernel disagrees with its plain "
                                 "version")
    # forced stop: random weights' group maxima mostly rise from the zero
    # state to a fixed point, and then one threshold splits the rows only
    # into "stop at the first eligible group" and "never". Rows that stop at
    # different groups need maxima that fall after group 6, which depends on
    # the weights and the text: the plain version tries 32 random texts with
    # mel_proj as drawn and negated, three draws at most, and the first
    # with three or more stop groups is held against the kernel
    for attempt in range(6):
        g = torch.Generator().manual_seed(100 + attempt // 2)
        lens = torch.randint(3, 60, (32,), generator=g).tolist()
        seqs = [torch.randint(1, 148, (n,), generator=g).tolist()
                for n in lens]
        sign = -1.0 if attempt % 2 == 0 else 1.0
        args = ({**dec, "mel_proj.weight": sign * dec["mel_proj.weight"]},
                *b8_inputs(tts, seqs, dev)[:3], 2, 400, 80, cfg.tts.max_r)
        with torch.no_grad():
            thr, predicted = stop_threshold(
                ctd.decode_batch_ref(*args, -1e30)[0], 2)
        if len(set(predicted)) >= 3:
            break
    B = 32
    with torch.no_grad():
        got = ctd.decode_batch(*args, thr)
        want = ctd.decode_batch_ref(*args, thr)
    chk, ok = check_b8(got, want, mel_tol, att_tol)
    nv = got[2].tolist()
    mel_k = got[0]
    frozen = all(torch.equal(mel_k[b, :, (n) * 2:(n + 1) * 2],
                             mel_k[b, :, -2:]) for b, n in enumerate(nv)
                 if n < 200)
    chk.update(threshold=thr, stop_groups=sorted(set(nv)),
               predicted_equal=nv == predicted, replay_frozen=frozen,
               attempt=attempt, mel_proj_sign=sign)
    ok = ok and frozen and len(set(nv)) >= 3
    res["forced_stop"] = chk
    emit("b8", case="forced_stop", B=B, ok=ok, mel_tolerance=mel_tol,
         attn_tolerance=att_tol, **chk)
    if not ok:
        raise AssertionError("B8 forced stop: kernel disagrees with its "
                             "plain version")
    return res, cases


B8RES_REPS = 3


def phase_b8res(cfg, dev, tts, build_log, mel_tol, att_tol):
    """The resident decode body (csrc/taco_decode_resident.cu, which every
    B2 and B8 launch runs on) against the plain versions and the original
    body (csrc/taco_decode.cu, ``_legacy=True``) at full width, r 2, 200
    groups: B 1 through B2's own entry point (the first test sentence, 42
    symbols, and 60 random symbols), B 5 (the five sentences, T_text 43), B
    32 (them repeated) and B 32 at T_text 150 (random texts of 100-150
    symbols), each with no stop and with a forced stop (the threshold from
    the plain run's group maxima: n_valid equal, every stopped row's later
    groups its frozen-state group bit for bit), each body's launch on its
    own counters; the plan on this card; both bodies in turns (new, old,
    old, new) with the clocks; the per-stage split of a group at B 1 and B
    32 (the profiling instantiation, clock64() on block 0); B 64 at T_text
    400, past a block's shared memory, in one launch against the plain
    version; nvcc's
    registers and spills of the four entries (a spill outside the
    profiling instantiations fails the phase)."""
    import torch
    from wavernn_tpu_torch.ops import cuda_taco as ctd
    from wavernn_tpu_torch.text import text_to_sequence
    t_start = time.perf_counter()
    dec = tts.decoder_weights()
    sents = [text_to_sequence(x, cfg.tts.cleaner_names) for x in SENTENCES[:5]]
    g = torch.Generator().manual_seed(60)
    rand = lambda n: torch.randint(1, 148, (n,), generator=g).tolist()
    long = [rand(int(n)) for n in torch.randint(100, 150, (31,), generator=g)]
    cases = {"B1_T42": [sents[0]], "B1_T60": [rand(60)], "B5_T43": sents,
             "B32_T43": [sents[i % 5] for i in range(32)],
             "B32_T150": [rand(150)] + long}
    entries, spills = ptxas_entries(build_log, "taco_dec_res")
    # the profiling instantiations' spills are reported, not failed on
    prod_spills = [x for x in spills if "_prof" not in x.split(":")[0]]
    res = {"shapes": {}, "turns": {}, "split": {}, "ptxas": entries,
           "spills": spills}
    ok_all = not prod_spills
    for name, seqs in cases.items():
        enc, encp, mask, _ = b8_inputs(tts, seqs, dev)
        B, T = enc.shape[:2]
        tail = (2, 400, 80, cfg.tts.max_r)
        if B == 1:
            run = lambda thr, **kw: ctd.decode(dec, enc, encp, mask[0], *tail,
                                               thr, **kw)
            plain = lambda thr: ctd.decode_ref(dec, enc, encp, mask[0], *tail,
                                               thr)
            keys = ("taco_decode", "taco_decode_legacy")
        else:
            run = lambda thr, **kw: ctd.decode_batch(dec, enc, encp, mask,
                                                     *tail, thr, **kw)
            plain = lambda thr: ctd.decode_batch_ref(dec, enc, encp, mask,
                                                     *tail, thr)
            keys = ("taco_decode_batch", "taco_decode_batch_legacy")
        dims = dict(B=B, T=T, E=enc.shape[2], D=encp.shape[2],
                    P1=dec["prenet.fc1.weight"].shape[0],
                    P2=dec["prenet.fc2.weight"].shape[0],
                    L=dec["res_rnn1.weight_hh"].shape[1], n_mels=80, r=2)
        plan = ctd.device_plan(dims, dev)
        shape = {"B": B, "T_text": T,
                 "plan": {"rt": plan["rt"], "rows": plan["rows"],
                          "kc": plan["kc"], "smem_bytes": plan["smem_bytes"],
                          "in_device_memory": [
                              k[4:] for k in plan if k.startswith("res_")
                              and not plan[k]]
                          + ([] if plan["e_smem"] else ["e"])}}
        with torch.no_grad():
            free = plain(-1e30)
            thr, predicted = stop_threshold(free[0], 2)
            for case, t in (("no_stop", -1e30), ("forced_stop", thr)):
                want = free if case == "no_stop" else plain(t)
                zero_counts()
                got = run(t)
                c1 = launch_counts()
                old = run(t, _legacy=True)
                c2 = launch_counts()
                new_chk, ok_new = check_b8(got, want, mel_tol, att_tol)
                old_chk, ok_old = check_b8(old, want, mel_tol, att_tol)
                nv = got[2].tolist()
                frozen = all(torch.equal(got[0][b, :, 2 * n:2 * n + 2],
                                         got[0][b, :, -2:])
                             for b, n in enumerate(nv) if n < 200)
                counted = ((c1[keys[0]], c1[keys[1]], c2[keys[0]], c2[keys[1]])
                           == (1, 0, 1, 1))
                ok = ok_new and ok_old and frozen and counted
                if case == "no_stop":
                    ok = ok and nv == [200] * B
                else:
                    ok = ok and nv == predicted
                shape[case] = {
                    "ok": ok, "threshold": t, "stop_groups": sorted(set(nv)),
                    "new_vs_plain": {k: v for k, v in new_chk.items()
                                     if k != "n_valid"},
                    "old_vs_plain": {k: v for k, v in old_chk.items()
                                     if k != "n_valid"},
                    "n_valid_equal": new_chk["n_valid"][0]
                    == new_chk["n_valid"][1],
                    "replay_frozen": frozen, "launches_counted": counted}
                ok_all = ok_all and ok
            res["turns"][name] = turns(lambda: run(-1e30),
                                       lambda: run(-1e30, _legacy=True),
                                       B8RES_REPS)
            if name in ("B1_T42", "B32_T43"):
                labels = ctd.RES_PROF + ctd.RES_SUBPROF
                prof = torch.zeros(len(labels), dtype=torch.int64, device=dev)
                run(-1e30, _profile=prof)
                torch.cuda.synchronize()
                res["split"][name] = {k: v / 200 for k, v in
                                      zip(labels, prof.tolist())}
        res["shapes"][name] = shape
        emit("b8res", case=name, ok=shape["no_stop"]["ok"]
             and shape["forced_stop"]["ok"], mel_tolerance=mel_tol,
             attn_tolerance=att_tol, **shape, turns=res["turns"][name])
    # past a block's shared memory (the plan puts the items' location
    # features in device memory): one launch against the plain version
    seqs = [rand(400)] + [rand(int(n)) for n in
                          torch.randint(300, 400, (63,), generator=g)]
    enc, encp, mask, _ = b8_inputs(tts, seqs, dev)
    args = (dec, enc, encp, mask, 2, 400, 80, cfg.tts.max_r, -1e30)
    with torch.no_grad():
        zero_counts()
        got = ctd.decode_batch(*args)
        c = launch_counts()
        want = ctd.decode_batch_ref(*args)
    chk, ok = check_b8(got, want, mel_tol, att_tol)
    ok = (ok and chk["n_valid"][0] == [200] * 64
          and (c["taco_decode_batch"], c["taco_decode_batch_legacy"]) == (1, 0))
    plan = ctd.device_plan(dict(B=64, T=400, E=enc.shape[2], D=encp.shape[2],
                                P1=dec["prenet.fc1.weight"].shape[0],
                                P2=dec["prenet.fc2.weight"].shape[0],
                                L=dec["res_rnn1.weight_hh"].shape[1],
                                n_mels=80, r=2), dev)
    res["shapes"]["B64_T400"] = {
        "B": 64, "T_text": 400, "e_in_device_memory": not plan["e_smem"],
        "new_vs_plain": {k: v for k, v in chk.items() if k != "n_valid"}}
    emit("b8res", case="B64_T400", ok=ok, mel_tolerance=mel_tol,
         attn_tolerance=att_tol, **res["shapes"]["B64_T400"])
    ok_all = ok_all and ok
    res["seconds"] = time.perf_counter() - t_start
    res["ok"] = ok_all
    emit("b8res", case="summary", ok=ok_all, ptxas=entries, spills=spills,
         split=res["split"], seconds=res["seconds"])
    if not ok_all:
        raise AssertionError("b8res: the resident decode body disagrees, "
                             "counts off its counters or spills")
    return res


def phase_serve(cfg, dev, tts, voc):
    """The serving paths at full width, steps 400 (random weights never
    stop): tts_to_wav_batch on the five sentences, tts_to_wav_fast and
    tts_to_wav(batched=False), and gen_tacotron --batch_sentences
    in-process. The launch counts are zeroed before each path and read
    after it. Returns {path: launch counts}."""
    import os
    import tempfile
    import numpy as np
    import torch
    from scipy.io import wavfile
    from wavernn_tpu_torch.cli import gen_tacotron
    from wavernn_tpu_torch.cli.common import make_workspace
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.synthesis import (tts_to_wav, tts_to_wav_batch,
                                             tts_to_wav_fast)
    from wavernn_tpu_torch.timing import elapsed_ms
    from wavernn_tpu_torch.train.checkpoints import save_checkpoint
    from wavernn_tpu_torch.train.wavernn_train import make_optimizer
    sr, hop = cfg.dsp.sample_rate, cfg.dsp.hop_length
    counts = {}

    def run(name, fn, want):
        zero_counts()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves = fn(timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = launch_counts()
        audio = sum(len(w) for w in waves) / sr
        finite = all(bool(np.isfinite(w).all()) for w in waves)
        peak = max(float(np.abs(w).max()) for w in waves)
        ok = (finite and peak <= math.sqrt(2) + 1e-9
              and all(c[k] == v for k, v in want.items()))
        counts[name] = c
        emit("serve", path=name, ok=ok, wall_s=wall, audio_s=audio,
             x_realtime=audio / wall, stage_ms=elapsed_ms(timings),
             launches=c, want_launches=want, waves=len(waves),
             wav_abs_max=peak)
        if not ok:
            raise AssertionError(f"serve {name}: bad wave or launch count")

    five = SENTENCES[:5]
    run("tts_to_wav_batch", lambda tm: [w for w, _ in tts_to_wav_batch(
        tts, voc, five, cfg, 2, steps=400,
        generator=torch.Generator().manual_seed(1), device=dev,
        timings=tm)],
        {"taco_decode_batch": 1, "sample_loop_fused": 1, "gru_res_fwd": 4,
         "gru_seq_fwd_legacy": 0, "taco_decode_legacy": 0,
         "taco_decode_batch_legacy": 0,
         "taco_decode": 0, "sample_loop_materialized": 0,
         "sample_loop_resident": 1, "sample_loop_old_dense": 0})
    run("tts_to_wav_fast", lambda tm: [tts_to_wav_fast(
        tts, voc, five[0], cfg, 2, steps=400,
        generator=torch.Generator().manual_seed(2), device=dev,
        timings=tm)[0]],
        {"taco_decode": 1, "sample_loop_fused": 1, "gru_res_fwd": 4,
         "gru_seq_fwd_legacy": 0, "taco_decode_legacy": 0,
         "taco_decode_batch_legacy": 0,
         "taco_decode_batch": 0, "sample_loop_materialized": 0,
         "sample_loop_resident": 1, "sample_loop_old_dense": 0})
    run("tts_to_wav_unbatched", lambda tm: [tts_to_wav(
        tts, voc, five[0], cfg, 2, steps=100,
        generator=torch.Generator().manual_seed(3), device=dev, timings=tm,
        batched=False)[0]],
        {"taco_decode": 1, "sample_loop_materialized": 1, "gru_res_fwd": 4,
         "gru_seq_fwd_legacy": 0, "taco_decode_legacy": 0,
         "taco_decode_batch_legacy": 0,
         "sample_loop_fused": 0, "taco_decode_batch": 0,
         "sample_loop_resident_mat": 1, "sample_loop_old_dense": 0})

    # the CLI in-process, from checkpoints in a temp workspace, on two
    # sentences (its decode bound is 2000 frames)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tmp = Path(tmp)
        (tmp / "two.txt").write_text("\n".join(five[:2]) + "\n")
        hp = tmp / "hparams_serve.py"
        hp.write_text("tts_model_id = 'serve'\nvoc_model_id = 'serve'\n"
                      f"test_sentences_file = {str(tmp / 'two.txt')!r}\n")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            cli_cfg = Config.from_hparams_file(hp)
            ws = make_workspace(cli_cfg)
            save_checkpoint("tts", ws, tts, make_optimizer(tts, 1e-3), 1000,
                            r=2, log=lambda *_: None)
            save_checkpoint("voc", ws, voc, make_optimizer(voc, 1e-4), 2000,
                            log=lambda *_: None)

            def cli(tm):
                gen_tacotron.main(["--hp_file", str(hp), "wavernn",
                                   "--batch_sentences"])
                return [wavfile.read(ws.tts_output / f"{i}_wavernn_batchN_1k"
                                     ".wav")[1].astype(np.float64) / 2 ** 15
                        for i in (1, 2)]
            run("cli_gen_tacotron_batch_sentences", cli,
                {"taco_decode_batch": 1, "sample_loop_fused": 1,
                 "gru_res_fwd": 4, "gru_seq_fwd_legacy": 0,
                 "taco_decode_legacy": 0, "taco_decode_batch_legacy": 0,
                 "sample_loop_resident": 1,
                 "sample_loop_old_dense": 0})
        finally:
            os.chdir(cwd)
    return counts


def phase_stream(cfg, dev, voc, mel):
    """StreamingVocoder over a 400-frame mel against one unbatched B3 launch
    with the same noise, and MultiStreamVocoder with 8 lanes fed out of
    step against their solo streams. Returns (B3 launches of the streamed
    runs, results)."""
    import torch
    from wavernn_tpu_torch.ops import cuda_gen as cg
    from wavernn_tpu_torch.streaming import (MultiStreamVocoder,
                                             StreamingVocoder)
    hop, sr = cfg.dsp.hop_length, cfg.dsp.sample_rate
    mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    frames = mel.shape[1]
    T = frames * hop
    u = cg.counter_uniforms(51, T, 1, 11, True, dev)
    noise = (u[..., :10], u[..., 10])
    with torch.no_grad():
        mu, au = voc.upsample(torch.nn.functional.pad(mel[None], (2, 2)))
        want, _ = cg.generate_materialized(voc.core_weights(), mu, au, "MOL",
                                           noise=noise)
    zero_counts()
    sv = StreamingVocoder(voc, chunk_frames=24, noise=noise, device=dev,
                          device_out=True)
    blocks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(0, frames, 50):
        blocks += sv.feed(mel[:, a:a + 50])
    blocks += sv.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lc = launch_counts()
    launched = lc["sample_loop_materialized"]
    on_resident = (lc["sample_loop_resident_mat"] == launched
                   and lc["sample_loop_old_dense"] == 0)
    got = torch.cat(blocks)
    err = (got - want[0]).abs()
    res = {"frames": frames, "samples": got.numel(), "blocks": len(blocks),
           "share_within_1e-3": float((err <= 1e-3).float().mean()),
           "share_equal": float((err == 0).float().mean()),
           "max_abs_err": float(err.max()), "wall_s": wall,
           "block_ms": 1e3 * wall / len(blocks),
           "block_audio_ms": 1e3 * 24 * hop / sr,
           "x_realtime": T / sr / wall, "launches": launched,
           "launches_on_resident_body": on_resident}
    ok = (got.shape == want[0].shape and res["share_within_1e-3"] >= 0.999
          and launched == len(blocks) and on_resident)
    emit("stream", case="streaming_vs_unbatched", ok=ok, **res)
    if not ok:
        raise AssertionError("stream: streamed samples disagree with the "
                             "unbatched run")

    # 8 lanes of 48-frame mels fed out of step, against solo streams
    n, W = 8, 48
    lanes = [mel[:, 7 * b: 7 * b + W] for b in range(n)]
    un = cg.counter_uniforms(52, W * hop, n, 11, True, dev)
    noise8 = (un[..., :10], un[..., 10])
    zero_counts()
    msv = MultiStreamVocoder(voc, n, chunk_frames=24, noise=noise8,
                             device=dev, device_out=True)
    outs = [[] for _ in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(6):
        for b in range(n):
            lo, hi = (8 + b) * step, (8 + b) * (step + 1)
            if lo < W:
                for sb, ys in msv.feed(b, lanes[b][:, lo:hi],
                                       drain=False).items():
                    outs[sb] += ys
        for sb, ys in msv.poll().items():
            outs[sb] += ys
    for b in range(n):
        for sb, ys in msv.flush(b).items():
            outs[sb] += ys
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    lc = launch_counts()
    launched += lc["sample_loop_materialized"]
    on_resident = (lc["sample_loop_resident_mat"]
                   == lc["sample_loop_materialized"] > 0
                   and lc["sample_loop_old_dense"] == 0)
    shares, equal = [], []
    for b in range(n):
        solo = StreamingVocoder(voc, chunk_frames=24, noise=(
            noise8[0][:, b:b + 1], noise8[1][:, b:b + 1]), device=dev,
            device_out=True)
        want_b = torch.cat(solo.feed(lanes[b]) + solo.flush())
        got_b = torch.cat(outs[b])
        e = (got_b - want_b).abs() if got_b.shape == want_b.shape \
            else torch.ones(1, device=dev)
        shares.append(float((e <= 1e-3).float().mean()))
        equal.append(float((e == 0).float().mean()))
    mres = {"lanes": n, "frames_per_lane": W, "share_within_1e-3": shares,
            "share_equal": equal, "wall_s": mwall,
            "x_realtime": n * W * hop / sr / mwall,
            "launches_on_resident_body": on_resident}
    ok = min(shares) >= 0.999 and on_resident
    emit("stream", case="multistream_lanes_vs_solo", ok=ok, **mres)
    if not ok:
        raise AssertionError("stream: a lane disagrees with its solo stream")
    return launched, res


def phase_prune(cfg, dev):
    """Pruned vocoder training and its serve at the full default Config():
    ``cli.train_wavernn --prune`` in-process for PRUNE_STEPS steps on a
    synthetic dataset, the schedule cut to reach the target at step 2
    (start 0, steps 2, every 1); the checkpoint's (128, 128)-block-dead
    weights and its pack (14 live blocks in the six per-step matrices at
    93.75 %); then ``cli.gen_wavernn --sparse`` on one held-out item, the
    launch counts zeroed before and read after. Returns the results."""
    import contextlib
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from scipy.io import wavfile
    from wavernn_tpu_torch.cli import gen_wavernn, train_wavernn
    from wavernn_tpu_torch.cli.common import load_voc_model
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.ops import cuda_gen, cuda_gru
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prune_") as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data", 40, 120, cfg.dsp.hop_length, 8)
        hp = tmp / "hparams_prune.py"
        hp.write_text(f"data_path = {str(tmp / 'data')!r}\n"
                      "voc_model_id = 'pruned'\n"
                      f"voc_total_steps = {PRUNE_STEPS}\n"
                      "voc_checkpoint_every = 1000\nvoc_test_samples = 2\n"
                      "voc_prune_start = 0\nvoc_prune_steps = 2\n"
                      "voc_prune_every = 1\n")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            zero_b5()
            t0 = time.perf_counter()
            train_wavernn.main(["--hp_file", str(hp), "--prune"])
            torch.cuda.synchronize()
            res["train_wall_s"] = time.perf_counter() - t0
            res["train_launches"] = b5_counts()
            ckpt = tmp / "checkpoints" / "pruned.wavernn"
            epochs = [r for r in map(json.loads, (ckpt / "metrics.jsonl")
                                     .read_text().splitlines())
                      if r["event"] == "epoch"]
            res["cli_steps"] = [r["step"] for r in epochs]
            res["cli_loss"] = [r["loss"] for r in epochs]
            res["cli_steps_per_s"] = [r["steps_per_s"] for r in epochs]
            pcfg = Config.from_hparams_file(hp)
            voc, step = load_voc_model(ckpt / "latest_weights.npz", pcfg,
                                       dev)
            core = voc.core_weights()
            pack = cuda_gen.pack_sparse(core, pcfg.voc)
            live = {n: pack.entries[n].live() if n in pack.entries else None
                    for n in cuda_gen.STEP_MATRICES}
            dead = {}
            for n, w in (("rnn1.weight_hh_l0", core["rnn1.weight_hh_l0"]),
                         ("rnn2.weight_hh_l0", core["rnn2.weight_hh_l0"]),
                         ("fc1.weight",
                          core["fc1.weight"][:, :cfg.voc.rnn_dims])):
                O, I = w.shape
                blocks = w.abs().reshape(O // 128, 128, I // 128, 128) \
                    .sum(dim=(1, 3))
                dead[n] = float((blocks == 0).float().mean())
            res.update(step=step, live_blocks=live,
                       live_total=sum(v or 0 for v in live.values()),
                       dead_block_share=dead)
            # the pruned serve: gen_wavernn --sparse, fold-batched (B1's
            # sparse arm), counts zeroed just before and read just after
            zero_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                gen_wavernn.main(["--hp_file", str(hp), "--sparse",
                                  "--samples", "1"])
            torch.cuda.synchronize()
            res["serve_wall_s"] = time.perf_counter() - t0
            res["serve_launches"] = launch_counts()
            wavs = sorted((tmp / "model_outputs" / "pruned.wavernn")
                          .glob("*gen_batched*.wav"))
            pcm = [wavfile.read(w)[1] for w in wavs]
            res["serve_wavs"] = [w.name for w in wavs]
            res["serve_pcm_peak"] = [int(np.abs(x.astype(int)).max())
                                     for x in pcm]
            res["serving_dense_said"] = "serving dense" in out.getvalue()
        finally:
            os.chdir(cwd)
    sl = res["serve_launches"]
    ok = (res["cli_steps"][-1:] == [PRUNE_STEPS]
          and all(math.isfinite(v) for v in res["cli_loss"])
          and b5_on_resident(res["train_launches"], 2 * PRUNE_STEPS,
                             2 * PRUNE_STEPS)
          and res["step"] == PRUNE_STEPS
          and all(v is not None for v in live.values())
          and 14 <= res["live_total"] <= 16
          and all(v >= 0.75 for v in dead.values())
          and sl["sample_loop_resident_sparse"] == 1
          and sl["sample_loop_fused"] == 1 and sl["sample_loop_sparse"] == 0
          and len(wavs) == 1 and res["serve_pcm_peak"][0] > 0
          and not res["serving_dense_said"])
    emit("prune", ok=ok, **res)
    if not ok:
        raise AssertionError("prune: the pruned train or its sparse serve "
                             "failed a check")
    return res


def turns(new, old, reps, per=1.0, same=None):
    """``new`` and ``old`` timed in turns (new, old, old, new) with the SM
    clock and clock-limit reasons read around them: ms per call (times
    ``per``), the ratio old / new of the better of each, whether every new
    time beat every old one, and (``same``) whether their outputs agree."""
    clk = [gpu_clocks()]
    n1, out_new = cuda_ms(new, reps)
    o1, out_old = cuda_ms(old, reps)
    o2, _ = cuda_ms(old, reps)
    n2, _ = cuda_ms(new, reps)
    clk.append(gpu_clocks())
    res = {"new": [per * n1, per * n2], "old": [per * o1, per * o2],
           "speedup": min(o1, o2) / min(n1, n2),
           "new_faster": max(n1, n2) < min(o1, o2), "clocks": clk}
    if same is not None:
        res["equal"] = bool(same(out_new, out_old))
    return res


def same_out(a, b):
    """Bit-for-bit equality of two outputs (tensors or nested tuples)."""
    import torch
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return all(same_out(x, y) for x, y in zip(a, b))


def prune_like_production(voc, block=None):
    """A copy of ``voc`` pruned as the reference fork's schedule ends:
    B9_SPARSITY in B9_BLOCK blocks (or ``block``), prune_rnn_input."""
    import copy
    from wavernn_tpu_torch.train import pruning
    pruned = copy.deepcopy(voc)
    params = dict(pruned.named_parameters())
    pruning.apply_masks(params, pruning.update_masks(
        params, 1, pruning.wavernn_prune_spec(True), 0, 1, B9_SPARSITY,
        block or B9_BLOCK))
    return pruned


def phase_sparse(cfg, dev, voc, mel, tol):
    """B9, the sparse arm of B1 and B3, on the resident body, on the main
    vocoder's weights pruned at 93.75 % in (128, 128) blocks. Bit for bit:
    the resident sparse arm against the original body's sparse arm
    (``_legacy=True``) and against the resident dense arm on the same
    masked weights, at the b1 shape (the main mel, 10 folds x 12,100
    steps) in bfloat16 and float32, at 1 / 10 / 50 / 128 / 500 rows, B3 at
    one row (and chained), MOL and RAW, injected noise and the counter
    hash, (128, 128) and ``allow_br8`` packs; one streaming block against
    the dense one. Against its plain version (float32 within ``tol``;
    bfloat16 at least 99 % within 1e-3). Timed in turns with the original
    body's sparse arm (resident, legacy, legacy, resident), the clocks read
    around each set, at the b1 shape and at 1, 10 and 50 rows, beside the
    dense resident arm (and its ratio to the original dense arm); B3's
    sparse arm at one row; the per-stage split of a sparse step (clock64()
    on block 0) at 1 and 10 rows; ``generate_fast`` dense and sparse.
    Returns the results."""
    import torch
    from wavernn_tpu_torch.config import WaveRNNConfig
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import cuda_gen as cg
    from wavernn_tpu_torch.streaming import StreamingVocoder
    f32 = torch.float32
    pad = torch.nn.functional.pad
    gen = torch.Generator().manual_seed(7531)
    pruned = prune_like_production(voc)
    core = pruned.core_weights()
    pack = cg.pack_sparse(core, cfg.voc)
    live = sum(pack.entries[n].live() for n in cg.STEP_MATRICES)
    n_rows = sum(pack.entries[n].shape[0] // 128 + 1
                 for n in cg.STEP_MATRICES)
    res = {"live_blocks": live, "packed": sorted(pack.entries)}
    exact = {}
    with torch.no_grad():
        mels = torch.as_tensor(mel)[None].to(dev)
        frames, phi, geo, chunks = wr.fused_conditioning(
            pruned, pad(mels, (2, 2)), mels.shape[-1] * 275, cfg.voc.target,
            cfg.voc.overlap)
        args = (core, frames, phi, geo.hop, -geo.d_lo, chunks, cfg.voc.mode)
        B, T = frames.shape[1], chunks * geo.hop

        def sparse(**kw):
            return cg.generate_fused(*args, seed=5, sparse_packed=pack, **kw)

        def dense(**kw):
            return cg.generate_fused(*args, seed=5, **kw)
        # ---- bit for bit at the b1 shape ----
        got16 = sparse()
        exact["b1_bf16_equal_legacy"] = same_out(got16, sparse(_legacy=True))
        exact["b1_bf16_equal_dense"] = same_out(got16, dense())
        got32 = sparse(compute_dtype=f32)
        exact["b1_f32_equal_legacy"] = same_out(
            got32, sparse(compute_dtype=f32, _legacy=True))
        exact["b1_f32_equal_dense"] = same_out(got32, dense(compute_dtype=f32))
        ref32 = cg.generate_fused_ref(*args, seed=5, sparse_packed=pack)
        chk, ok32 = check_b1_f32("f32", got32, ref32, tol)
        res.update(chk)
        core16 = cg.round_core_like_kernel(core)
        pack16 = cg.pack_sparse(core16, cfg.voc)
        res["plain_ms"], ref16 = once_ms(lambda: cg.generate_fused_ref(
            core16, *args[1:], seed=5, sparse_packed=pack16))
        chk, ok16 = check_b1_bf16(got16, ref16)
        res.update(chk)
        # ---- timed in turns at the b1 shape: the sparse arms, then the
        # dense arms ----
        res["b1_shape"] = {"folds": B, "steps": T}
        res["b1_sparse_turns_ms"] = turns(sparse, lambda: sparse(_legacy=True),
                                          1, same=same_out)
        res["b1_dense_turns_ms"] = turns(dense, lambda: dense(_legacy=True), 1,
                                         same=same_out)
        # ---- rows: 1, 10 and 50 timed (8 hop-chunks), 128 and 500 checked
        # (2 hop-chunks) ----
        sweep = {}
        for nb, nc in ((1, 8), (10, 8), (50, 8), (128, 2), (500, 2)):
            fr = torch.rand(nc + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            a8 = (core, fr, phi, geo.hop, -geo.d_lo, nc, cfg.voc.mode)
            dts = (("bf16", torch.bfloat16), ("f32", f32)) if nb == 128 \
                else (("bf16", torch.bfloat16),)
            for dn, dt in dts:
                new = cg.generate_fused(*a8, seed=6, sparse_packed=pack,
                                        compute_dtype=dt)
                exact[f"b1_{nb}_rows_{dn}_equal_legacy"] = same_out(
                    new, cg.generate_fused(*a8, seed=6, sparse_packed=pack,
                                           compute_dtype=dt, _legacy=True))
                exact[f"b1_{nb}_rows_{dn}_equal_dense"] = same_out(
                    new, cg.generate_fused(*a8, seed=6, compute_dtype=dt))
            if nb > 50:
                continue
            per = 1e3 / (nc * geo.hop)
            sweep[nb] = {
                "sparse_us": turns(
                    lambda: cg.generate_fused(*a8, seed=5, sparse_packed=pack),
                    lambda: cg.generate_fused(*a8, seed=5, sparse_packed=pack,
                                              _legacy=True), 1, per),
                "dense_us": turns(
                    lambda: cg.generate_fused(*a8, seed=5),
                    lambda: cg.generate_fused(*a8, seed=5, _legacy=True), 1,
                    per)}
        res["us_per_step_by_rows"] = sweep
        # ---- the per-stage split of a sparse step, block 0 ----
        clock = gpu_clocks()
        mhz = float(clock.split(" MHz")[0]) if " MHz" in clock else None
        split = {}
        for nb in (1, 10):
            fr = torch.rand(8 + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            _, cyc, steps = cg.generate_fused_profiled(
                core, fr, phi, geo.hop, -geo.d_lo, 8, cfg.voc.mode, seed=5,
                sparse_packed=pack)
            split[nb] = {st: {k: v / steps for k, v in kinds.items()}
                         for st, kinds in cyc.items() if st != "prologue"}
            split[nb]["step_cycles"] = sum(sum(k.values()) for k in
                                           split[nb].values())
            if mhz:
                split[nb]["step_us_at_sm_clock"] = (split[nb]["step_cycles"]
                                                    / mhz)
        res["split_cycles_per_step"] = split
        res["split_sm_clock"] = clock
        # ---- the vocoder half of a pruned serve (generate_fast on the main
        # mel), dense and sparse: the sample loop's share ----
        from wavernn_tpu_torch.timing import elapsed_ms
        serve = {}
        for tag, sp in (("dense", None), ("sparse", pack)):
            wr.generate_fast(pruned, mels, sparse_packed=sp, device=dev)
            tm = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = wr.generate_fast(pruned, mels, sparse_packed=sp,
                                   device=dev, timings=tm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stages = elapsed_ms(tm)
            serve[tag] = {"wall_s": wall, "stage_ms": stages,
                          "sample_share": stages["sample_kernel"]
                          / sum(stages.values()),
                          "x_realtime": wav.numel() / cfg.dsp.sample_rate
                          / wall}
        res["generate_fast"] = serve
        # ---- B3's sparse arm at one row (2,000 steps, chained 1,000 +
        # 1,000), timed in turns at one streaming block's 6,600 steps ----
        mu, au = pruned.upsample(pad(mels, (2, 2)))
        mu1, au1 = mu[:, :2000].contiguous(), au[:, :2000].contiguous()
        u = cg.counter_uniforms(54, 2000, 1, 11, True, dev)
        nz = (u[..., :10], u[..., 10])

        def cut(a, b):
            return (nz[0][a:b], nz[1][a:b])
        for dn, dt in (("bf16", torch.bfloat16), ("f32", f32)):
            kw = dict(noise=nz, compute_dtype=dt)
            new = cg.generate_materialized(core, mu1, au1, cfg.voc.mode,
                                           sparse_packed=pack, **kw)
            exact[f"b3_1row_{dn}_equal_legacy"] = same_out(
                new, cg.generate_materialized(core, mu1, au1, cfg.voc.mode,
                                              sparse_packed=pack,
                                              _legacy=True, **kw))
            exact[f"b3_1row_{dn}_equal_dense"] = same_out(
                new, cg.generate_materialized(core, mu1, au1, cfg.voc.mode,
                                              **kw))
        y1, st1 = cg.generate_materialized(
            core, mu1[:, :1000], au1[:, :1000], cfg.voc.mode, noise=cut(0, 1000),
            sparse_packed=pack)
        y2, st2 = cg.generate_materialized(
            core, mu1[:, 1000:], au1[:, 1000:], cfg.voc.mode,
            noise=cut(1000, 2000), init_state=st1, sparse_packed=pack)
        y, st = cg.generate_materialized(core, mu1, au1, cfg.voc.mode, noise=nz,
                                         sparse_packed=pack)
        exact["b3_chained_1000_equal_one_launch"] = (
            same_out(torch.cat([y1, y2], dim=1), y) and same_out(st2, st))
        y32, _ = cg.generate_materialized(core, mu1, au1, cfg.voc.mode,
                                          seed=9, compute_dtype=f32,
                                          sparse_packed=pack)
        p32, _ = cg.generate_materialized_ref(core, mu1, au1, cfg.voc.mode,
                                              seed=9, sparse_packed=pack)
        chk, ok3 = check_b1_f32("b3_1row_f32", y32, p32, tol)
        res.update(chk)
        T3 = 24 * geo.hop
        m3, a3 = mu[:, :T3].contiguous(), au[:, :T3].contiguous()
        res["b3_block_turns_ms"] = turns(
            lambda: cg.generate_materialized(core, m3, a3, cfg.voc.mode,
                                             seed=7, sparse_packed=pack),
            lambda: cg.generate_materialized(core, m3, a3, cfg.voc.mode,
                                             seed=7, sparse_packed=pack,
                                             _legacy=True), 1, same=same_out)
        res["b3_block_dense_ms"] = cuda_ms(lambda: cg.generate_materialized(
            core, m3, a3, cfg.voc.mode, seed=7), 1)[0]
        core3 = cg.round_core_like_kernel(core)
        res["b3_block_plain_ms"], _ = once_ms(
            lambda: cg.generate_materialized_ref(
                core3, m3, a3, cfg.voc.mode, seed=7,
                sparse_packed=cg.pack_sparse(core3, cfg.voc)))
        res["b3_block_shape"] = [1, T3]
        # ---- RAW, and the allow_br8 schedule's (128, 8) blocks, at a
        # narrow tile of the b1 shape (10 folds x 2 hop-chunks) ----
        fr = torch.rand(2 + geo.K - 1, 10, frames.shape[2],
                        generator=gen).to(dev)
        for name, vk, block, br8 in (("raw", "RAW", None, False),
                                      ("br8", "MOL", (8, 128), True)):
            v = wr.WaveRNN(WaveRNNConfig(mode=vk), cfg.dsp)
            v.reset_parameters(gen)
            pv = prune_like_production(v.to(dev).eval(), block)
            cv = pv.core_weights()
            pk = cg.pack_sparse(cv, cfg.voc, allow_br8=br8)
            exact[f"{name}_packed"] = set(cg.STEP_MATRICES) <= set(pk.entries)
            a2 = (cv, fr, phi, geo.hop, -geo.d_lo, 2, vk)
            nu = 11 if vk == "MOL" else cv["fc3.weight"].shape[0]
            un = cg.counter_uniforms(55, 2 * geo.hop, 10, nu, vk == "MOL",
                                     dev)
            nzr = (un[..., :nu - 1], un[..., nu - 1]) if vk == "MOL" else un
            for dn, dt in (("bf16", torch.bfloat16), ("f32", f32)):
                for nn, nzk in (("noise", {"noise": nzr}), ("hash", {"seed": 8})):
                    new = cg.generate_fused(*a2, sparse_packed=pk,
                                            compute_dtype=dt, **nzk)
                    exact[f"{name}_b1_{dn}_{nn}_equal_legacy"] = same_out(
                        new, cg.generate_fused(*a2, sparse_packed=pk,
                                               compute_dtype=dt, _legacy=True,
                                               **nzk))
                    exact[f"{name}_b1_{dn}_{nn}_equal_dense"] = same_out(
                        new, cg.generate_fused(*a2, compute_dtype=dt, **nzk))
            mur = mu1[:, :600].contiguous()
            aur = au1[:, :600].contiguous()
            new = cg.generate_materialized(cv, mur, aur, vk, seed=10,
                                           sparse_packed=pk)
            exact[f"{name}_b3_1row_equal_legacy"] = same_out(
                new, cg.generate_materialized(cv, mur, aur, vk, seed=10,
                                              sparse_packed=pk, _legacy=True))
            exact[f"{name}_b3_1row_equal_dense"] = same_out(
                new, cg.generate_materialized(cv, mur, aur, vk, seed=10))
        # ---- one streaming block, sparse against dense ----
        u = cg.counter_uniforms(53, 24 * 275, 1, 11, True, dev)
        blocks = {}
        zero_counts()
        for tag, sp in (("dense", None), ("sparse", pack)):
            sv = StreamingVocoder(pruned, chunk_frames=24,
                                  noise=(u[..., :10], u[..., 10]),
                                  device=dev, device_out=True,
                                  sparse_packed=sp)
            blocks[tag] = sv.feed(mel[:, :24 + 2])
        res["stream_launches"] = launch_counts()
        exact["stream_block_equal_dense"] = (
            len(blocks["sparse"]) == len(blocks["dense"]) == 1
            and same_out(blocks["sparse"][0], blocks["dense"][0]))
    R, FC = cfg.voc.rnn_dims, cfg.voc.fc_dims
    fl, by = b9_work(B, T, chunks, R, FC, cfg.voc.aux_dims, 80, 30, geo.K, 2,
                     live, n_rows)
    bt = res["b1_sparse_turns_ms"]
    res.update(flops=fl, bytes=by, ms=min(bt["new"]), legacy_ms=min(bt["old"]),
               dense_ms=min(res["b1_dense_turns_ms"]["new"]),
               dense_legacy_ms=min(res["b1_dense_turns_ms"]["old"]))
    res["bound_ms"], res["bound_by"] = bound(fl, by, PEAK_BF16)
    fl3, by3 = b9_mat_work(1, T3, R, FC, cfg.voc.aux_dims, 80, 30, 2, live,
                           n_rows)
    res["b3_block_bound_ms"], res["b3_block_bound_by"] = bound(fl3, by3,
                                                               PEAK_BF16)
    exact.update({f"timed_{k}": v["equal"] for k, v in
                  (("b1_sparse", res["b1_sparse_turns_ms"]),
                   ("b1_dense", res["b1_dense_turns_ms"]),
                   ("b3_block", res["b3_block_turns_ms"]))})
    res["exact"] = exact
    res["faster"] = {"b1_shape": res["b1_sparse_turns_ms"]["new_faster"],
                     "b3_block": res["b3_block_turns_ms"]["new_faster"],
                     **{f"{nb}_rows": v["sparse_us"]["new_faster"]
                        for nb, v in sweep.items()}}
    sl = res["stream_launches"]
    ok = (ok32 and ok16 and ok3 and all(exact.values())
          and sl["sample_loop_resident_mat_sparse"] == 1
          and sl["sample_loop_resident_mat"] == 1
          and sl["sample_loop_sparse"] == 0 and sl["sample_loop_old_dense"] == 0
          and sorted(pack.entries) == sorted(cg.STEP_MATRICES))
    emit("sparse", ok=ok, tolerance=tol, **res)
    if not ok:
        raise AssertionError("sparse: B9 disagrees with the original body, "
                             "the dense kernel or its plain version")
    return res


def phase_seam(cfg, dev, voc, mel, tol):
    """B4b, B1's state arm, and exact-seam generation at the full default
    Config: B4b against its plain version (10 folds x 4 hop-chunks from a
    given state, snapshot at target + overlap; float32 MOL and RAW within
    ``tol``, bfloat16 at least 99 % within 1e-3); one launch against two
    chained at a chunk boundary and a snapshot there against the shorter
    launch's state (bit for bit, injected noise); the sequential oracle at
    target 11000 / overlap 550 over 3 folds (the fused seam after 2 passes
    against one one-row fused launch, the materialized seam against one
    unbatched B3 launch, bit for bit); then ``generate_sharded
    (seam_passes=2)`` on the main mel (launches counted: 3 of B4b, none of
    B1 or B3), crossfade mode and ``generate_fast`` beside it; and B4b
    timed in turns with B1 at the b1 shape, the clocks read around them.
    Returns the results."""
    import numpy as np
    import torch
    from wavernn_tpu_torch.config import WaveRNNConfig
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import cuda_gen as cg
    from wavernn_tpu_torch.ops import polyphase as P
    from wavernn_tpu_torch.ops.fold import fold_with_overlap
    from wavernn_tpu_torch.parallel import gen_sharded as gs
    pad = torch.nn.functional.pad
    f32 = torch.float32
    gen = torch.Generator().manual_seed(4321)
    R, FC, A = cfg.voc.rnn_dims, cfg.voc.fc_dims, cfg.voc.aux_dims
    res, oks = {}, {}

    def rand_state(B):
        return tuple(t.to(dev) for t in (torch.rand(B, R, generator=gen) - 0.5,
                                         torch.rand(B, R, generator=gen) - 0.5,
                                         torch.rand(B, generator=gen) * 2 - 1))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with torch.no_grad():
        # ---- B4b against its plain version; chaining ----
        for mode in ("MOL", "RAW"):
            v = wr.WaveRNN(WaveRNNConfig(mode=mode), cfg.dsp)
            v.reset_parameters(gen)
            v = v.to(dev).eval()
            core = v.core_weights()
            mels = torch.rand(1, 80, 30, generator=gen).to(dev)
            frames, phi, geo, chunks = wr.fused_conditioning(
                v, pad(mels, (2, 2)), 30 * 275, 550, 275)
            B, T = frames.shape[1], chunks * geo.hop
            NC = core["fc3.weight"].shape[0]
            nu = NC // 3 + 1 if mode == "MOL" else NC
            u = cg.counter_uniforms(98, T, B, nu, mode == "MOL", dev)
            noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
            args = (core, frames, phi, geo.hop, -geo.d_lo, chunks, mode)
            state = rand_state(B)
            kw = dict(noise=noise, init_state=state, state_snapshot_at=825)
            got, st = cg.generate_fused_with_state(*args, compute_dtype=f32,
                                                   **kw)
            ref, st_p = cg.generate_fused_with_state_ref(*args, **kw)
            chk, oks[mode] = check_b1_f32(f"{mode}_f32", got, ref, tol)
            res.update(chk)
            err = max(float((a - b).abs().max()) for a, b in zip(st, st_p))
            res[f"{mode}_f32_state_max_abs_err"] = err
            oks[mode] = oks[mode] and err <= tol
            if mode != "MOL":
                continue
            got16, _ = cg.generate_fused_with_state(*args, **kw)
            ref16, _ = cg.generate_fused_with_state_ref(
                cg.round_core_like_kernel(core), *args[1:], **kw)
            chk, oks["bf16"] = check_b1_bf16(got16, ref16)
            res.update(chk)
            # chained at chunk boundary 2 (bfloat16, as the seams run)
            c1 = 2
            T1 = c1 * geo.hop
            y, st = cg.generate_fused_with_state(*args, noise=noise,
                                                 init_state=state)
            y1, st1 = cg.generate_fused_with_state(
                core, frames[:c1 + geo.K - 1].contiguous(), phi, geo.hop,
                -geo.d_lo, c1, mode, noise=tuple(n[:T1] for n in noise),
                init_state=state)
            y2, st2 = cg.generate_fused_with_state(
                core, frames[c1:].contiguous(), phi, geo.hop, -geo.d_lo,
                chunks - c1, mode, noise=tuple(n[T1:] for n in noise),
                init_state=st1)
            _, snap = cg.generate_fused_with_state(
                *args, noise=noise, init_state=state, state_snapshot_at=T1)
            res["chained_equal_one_launch"] = bool(
                torch.equal(torch.cat([y1, y2], dim=1), y) and same(st2, st))
            res["snapshot_equal_shorter_launch"] = same(snap, st1)
        res["b4b_shape"] = [B, T]

        # ---- the sequential oracle at the default target and overlap ----
        core = voc.core_weights()
        target, overlap, n = cfg.voc.target, cfg.voc.overlap, 3
        seg, L = target + overlap, target + 2 * overlap
        total = n * seg + overlap
        n_fr = total // 275
        u = cg.counter_uniforms(77, total, 1, 11, True, dev)
        g = (torch.arange(n, device=dev)[None] * seg
             + torch.arange(L, device=dev)[:, None])
        noise_1, noise_f = (u[..., :10], u[..., 10]), (u[g, 0, :10],
                                                       u[g, 0, 10])
        mels_p = pad(torch.rand(1, 80, n_fr, generator=gen).to(dev), (2, 2))
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, mels_p, total, target, overlap)
        one = P.build_folded_frames(mels_p[0].t(),
                                    voc.upsample.resnet(mels_p)[0].t(), 1, 0,
                                    n_fr, geo.K, geo.d_lo)
        seq = cg.generate_fused(core, one, phi, geo.hop, -geo.d_lo, n_fr,
                                "MOL", noise=noise_1)
        y, errs = gs.generate_exact_seam_fused(
            core, frames, phi, geo.hop, -geo.d_lo, chunks, "MOL", target,
            overlap, seam_passes=n - 1, noise=noise_f)
        res["oracle"] = {"folds": n, "steps": total, "fused_seam_errs":
                         errs.tolist(), "fused_equal_sequential": bool(
                             torch.equal(gs.concat_folds(y, target, overlap,
                                                         total), seq[0]))}
        mu, au = voc.upsample(mels_p)
        seq, _ = cg.generate_materialized(core, mu, au, "MOL", noise=noise_1)
        y, errs = gs.generate_exact_seam(
            core, fold_with_overlap(mu, target, overlap),
            fold_with_overlap(au, target, overlap), "MOL", target, overlap,
            seam_passes=n - 1, noise=noise_f)
        res["oracle"]["materialized_seam_errs"] = errs.tolist()
        res["oracle"]["materialized_equal_sequential"] = bool(torch.equal(
            gs.concat_folds(y, target, overlap, total), seq[0]))

        # ---- the path: generate_sharded on the main mel ----
        mels = torch.as_tensor(mel)[None].to(dev)
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, pad(mels, (2, 2)), mels.shape[-1] * 275, target, overlap)
        # each pass's seam error (and the warm-up of the timed call)
        _, errs = gs.generate_exact_seam_fused(
            core, frames, phi, geo.hop, -geo.d_lo, chunks, cfg.voc.mode,
            target, overlap, seam_passes=2, seed=5)
        errs = errs.tolist()
    path = {}
    for tag, passes in (("seam", 2), ("crossfade", 0)):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        wav = gs.generate_sharded(voc, mels, seam_passes=passes, device=dev,
                                  generator=torch.Generator().manual_seed(5))
        wall = time.perf_counter() - t0
        audio = len(wav) / cfg.dsp.sample_rate
        path[tag] = {"wall_s": wall, "audio_s": audio,
                     "x_realtime": audio / wall, "launches": launch_counts(),
                     "wav_finite": bool(np.isfinite(wav).all()),
                     "wav_abs_max": float(np.abs(wav).max())}
    path["crossfade"]["last_stats"] = dict(gs.last_stats)
    path["seam"]["seam_errs"] = errs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = wr.generate_fast(voc, mels, device=dev,
                           generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path["generate_fast"] = {"wall_s": wall, "x_realtime":
                             wav.numel() / cfg.dsp.sample_rate / wall}
    res["path"] = path
    seam_l, xf_l = path["seam"]["launches"], path["crossfade"]["launches"]

    # ---- B4b timed in turns with B1 at the b1 shape ----
    with torch.no_grad():
        args = (core, frames, phi, geo.hop, -geo.d_lo, chunks, cfg.voc.mode)
        B, T = frames.shape[1], chunks * geo.hop
        state = rand_state(B)
        kw = dict(seed=5, init_state=state, state_snapshot_at=target + overlap)
        clk = [gpu_clocks()]
        b1a, _ = cuda_ms(lambda: cg.generate_fused(*args, seed=5), 2)
        b4a, (got, _) = cuda_ms(lambda: cg.generate_fused_with_state(
            *args, **kw), 2)
        b4b, _ = cuda_ms(lambda: cg.generate_fused_with_state(*args, **kw), 2)
        b1b, _ = cuda_ms(lambda: cg.generate_fused(*args, seed=5), 2)
        clk.append(gpu_clocks())
        p_ms, (ref, _) = once_ms(lambda: cg.generate_fused_with_state_ref(
            cg.round_core_like_kernel(core), *args[1:], **kw))
        chk, ok_t = check_b1_bf16(got, ref)
    fl, by = b4b_work(B, T, chunks, R, FC, A, 80, 30, geo.K, 2)
    b_ms, b_by = bound(fl, by, PEAK_BF16)
    res["timing"] = {"folds": B, "steps": T, "b1_ms": [b1a, b1b],
                     "b4b_ms": [b4a, b4b], "ms": min(b4a, b4b),
                     "b1_min_ms": min(b1a, b1b),
                     "b4b_over_b1": min(b4a, b4b) / min(b1a, b1b),
                     "us_per_step": 1e3 * min(b4a, b4b) / T,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "flops": fl, "bytes": by, "clocks": clk, "check": chk}
    res["max_abs_err"] = max(res["MOL_f32_max_abs_err"],
                             res["MOL_f32_state_max_abs_err"],
                             res["RAW_f32_max_abs_err"],
                             res["RAW_f32_state_max_abs_err"])
    ok = (all(oks.values()) and ok_t and res["chained_equal_one_launch"]
          and res["snapshot_equal_shorter_launch"]
          and res["oracle"]["fused_equal_sequential"]
          and res["oracle"]["materialized_equal_sequential"]
          and seam_l["sample_loop_fused_state"] == 3
          and seam_l["sample_loop_resident_state"] == 3
          and seam_l["sample_loop_old_dense"] == 0
          and xf_l["sample_loop_resident"] == 1
          and xf_l["sample_loop_old_dense"] == 0
          and seam_l["sample_loop_fused"] == 0
          and seam_l["sample_loop_materialized"] == 0
          and xf_l["sample_loop_fused"] == 1
          and xf_l["sample_loop_fused_state"] == 0
          and errs[-1] <= errs[0] + 1e-6
          and path["seam"]["wav_finite"] and path["crossfade"]["wav_finite"]
          and path["seam"]["wav_abs_max"] <= 1.0
          and path["crossfade"]["wav_abs_max"] <= math.sqrt(2) + 1e-6)
    emit("seam", ok=ok, tolerance=tol, **res)
    if not ok:
        raise AssertionError("seam: B4b disagrees with its plain version, a "
                             "handoff is not exact, or the seam path did not "
                             "run on B4b")
    return res


def phase_resident(cfg, dev, voc, mel, build_log, tol):
    """The resident body (csrc/sample_loop_resident.cu) against the original
    body's dense arm (``_legacy=True``), bit for bit: B1 at the b1 shape
    (10 folds x 4 hop-chunks; MOL and RAW, float32 and bfloat16, injected
    noise and the counter hash) and at the main mel's 10 x 12,100; B4b from
    a state with a snapshot inside, chained at a chunk boundary; B3 / B4a
    at 3 x 1,000 and 10 x 2,000 from a state with a snapshot inside, and
    two chained launches of 1,000; many rows (B1 at 128 rows in both
    dtypes and 500 in bfloat16, B4b and B3 at 200 rows in float32: past
    132 blocks, the per-row regions in device memory where the plan puts
    them there). The original body's dense arm also against its plain
    version on the same inputs, within ``tol`` (B1 at the b1 shape, MOL and
    RAW; B4b from the state; B3 at 3 x 1,000 from the state; float32,
    injected noise): its entries' errors in the kernels line. Then both
    bodies timed in turns (new, old, old, new), the SM clock and
    clock-limit reasons read around each set: B1 at 1, 10, 32, 50 and 128
    rows over 8 hop-chunks, at 500 rows over 2 and at the main path's
    10 x 12,100, B4b there, B3 at 1 x 12,100 and 10 x 12,100 (the main mel
    upsampled and folded), each timed pair's outputs held equal too (32
    rows and more take the several-tile path); the per-stage split of a B1
    step at 1 and 10 rows (clock64() on block 0,
    ``generate_fused_profiled``); nvcc's registers, shared memory and
    spills for the new instantiations. Returns the results."""
    import torch
    from wavernn_tpu_torch.config import WaveRNNConfig
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import cuda_gen as cg
    from wavernn_tpu_torch.ops.fold import fold_with_overlap
    f32, bf16 = torch.float32, torch.bfloat16
    pad = torch.nn.functional.pad
    gen = torch.Generator().manual_seed(9876)
    R, FC, A = cfg.voc.rnn_dims, cfg.voc.fc_dims, cfg.voc.aux_dims
    # nvcc -Xptxas -v for each instantiation: its name, registers, shared
    # memory (static; the plan's dynamic bytes are below) and spills
    ptxas = [ln.split("info    : ")[-1].strip()
             for ln in build_log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the plan's dynamic shared memory a block and, where the per-row
    # regions moved to device memory, their bytes a block there
    plans = {f"{dn}_{B}_rows": [p.smem_bytes, p.row_bytes] for dn, dt in (
        ("bf16", torch.bfloat16), ("f32", torch.float32))
        for B in (1, 10, 50, 128, 500)
        for p in [cg.resident_plan(R, FC, 30, A, 80, B, sms, dt, 5)]}
    exact, res = {}, {"ptxas": ptxas, "smem_and_row_bytes": plans,
                      "spills": [ln for ln in ptxas
                                 if re.search(r"\b[1-9]\d* bytes spill", ln)]}
    # the original body's dense arm against its plain version: errors, oks
    old_plain, old_ok = {}, {}

    def hold_old(tag, old, ref):
        """``old`` (samples, or samples and state) of the original body
        against the plain version's ``ref``, float32: the samples by
        check_b1_f32, the state's largest difference within ``tol``."""
        got, want = (old, ref) if isinstance(old, torch.Tensor) else \
            (old[0], ref[0])
        chk, ok = check_b1_f32(tag, got, want, tol)
        old_plain.update(chk)
        if not isinstance(old, torch.Tensor):
            err = max(float((a - b).abs().max())
                      for a, b in zip(old[1], ref[1]))
            old_plain[f"{tag}_state_max_abs_err"] = err
            ok = ok and err <= tol
        old_ok[tag] = ok

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return bool(torch.equal(a, b))
        return all(same(x, y) for x, y in zip(a, b))

    def rand_state(B):
        return tuple(t.to(dev) for t in (torch.rand(B, R, generator=gen) - 0.5,
                                         torch.rand(B, R, generator=gen) - 0.5,
                                         torch.rand(B, generator=gen) * 2 - 1))

    def uniforms(seed, T, B, NC, mode):
        nu = NC // 3 + 1 if mode == "MOL" else NC
        u = cg.counter_uniforms(seed, T, B, nu, mode == "MOL", dev)
        return (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u

    def cut(noise, a, b):
        return tuple(v[a:b] for v in noise) if isinstance(noise, tuple) \
            else noise[a:b]

    dts = (("f32", f32), ("bf16", bf16))
    with torch.no_grad():
        # ---- B1 and B4b at the b1 shape ----
        for mode in ("MOL", "RAW"):
            v = wr.WaveRNN(WaveRNNConfig(mode=mode), cfg.dsp)
            v.reset_parameters(gen)
            core = v.to(dev).eval().core_weights()
            mels = torch.rand(1, 80, 30, generator=gen).to(dev)
            frames, phi, geo, chunks = wr.fused_conditioning(
                v, pad(mels, (2, 2)), 30 * 275, 550, 275)
            B, T = frames.shape[1], chunks * geo.hop
            noise = uniforms(61, T, B, core["fc3.weight"].shape[0], mode)
            args = (core, frames, phi, geo.hop, -geo.d_lo, chunks, mode)
            for dn, dt in dts:
                for nn, nz in (("noise", {"noise": noise}),
                               ("hash", {"seed": 62})):
                    old = cg.generate_fused(*args, compute_dtype=dt,
                                            _legacy=True, **nz)
                    exact[f"b1_{mode}_{dn}_{nn}"] = same(
                        cg.generate_fused(*args, compute_dtype=dt, **nz),
                        old)
                    if dn == "f32" and nn == "noise":
                        hold_old(f"b1_{mode}_f32", old,
                                 cg.generate_fused_ref(*args, noise=noise))
                state = rand_state(B)
                kw = dict(noise=noise, init_state=state,
                          state_snapshot_at=825, compute_dtype=dt)
                old = cg.generate_fused_with_state(*args, **kw, _legacy=True)
                exact[f"b4b_{mode}_{dn}_snapshot_825"] = same(
                    cg.generate_fused_with_state(*args, **kw), old)
                if dn == "f32" and mode == "MOL":
                    kw.pop("compute_dtype")
                    hold_old("b4b_MOL_f32", old,
                             cg.generate_fused_with_state_ref(*args, **kw))
            c1, K = 2, geo.K
            T1 = c1 * geo.hop
            state = rand_state(B)
            y, st = cg.generate_fused_with_state(*args, noise=noise,
                                                 init_state=state)
            y1, st1 = cg.generate_fused_with_state(
                core, frames[:c1 + K - 1].contiguous(), phi, geo.hop,
                -geo.d_lo, c1, mode, noise=cut(noise, 0, T1),
                init_state=state)
            y2, st2 = cg.generate_fused_with_state(
                core, frames[c1:].contiguous(), phi, geo.hop, -geo.d_lo,
                chunks - c1, mode, noise=cut(noise, T1, T), init_state=st1)
            _, snap = cg.generate_fused_with_state(
                *args, noise=noise, init_state=state, state_snapshot_at=T1)
            old = cg.generate_fused_with_state(*args, noise=noise,
                                               init_state=state, _legacy=True)
            exact[f"b4b_{mode}_equal_old_body"] = same((y, st), old)
            exact[f"b4b_{mode}_chained_equal_one_launch"] = (
                same(torch.cat([y1, y2], dim=1), y) and same(st2, st))
            exact[f"b4b_{mode}_snapshot_equal_shorter_launch"] = same(snap,
                                                                     st1)
        res["b1_shape"] = [B, T]
        # ---- B1 at the main mel's 10 x 12,100 ----
        core, mode = voc.core_weights(), cfg.voc.mode
        mels = torch.as_tensor(mel)[None].to(dev)
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, pad(mels, (2, 2)), mels.shape[-1] * 275, cfg.voc.target,
            cfg.voc.overlap)
        margs = (core, frames, phi, geo.hop, -geo.d_lo, chunks, mode)
        Bm, Tm = frames.shape[1], chunks * geo.hop
        for dn, dt in dts:
            exact[f"b1_main_{dn}_hash"] = same(
                cg.generate_fused(*margs, seed=5, compute_dtype=dt),
                cg.generate_fused(*margs, seed=5, compute_dtype=dt,
                                  _legacy=True))
        res["main_shape"] = [Bm, Tm]
        # ---- B3 / B4a ----
        for B3, T3 in ((3, 1000), (10, 2000)):
            mu = torch.rand(B3, T3, 80, generator=gen).to(dev)
            au = (torch.rand(B3, T3, 4 * A, generator=gen) * 2 - 1).to(dev)
            noise = uniforms(63, T3, B3, 30, mode)
            state = rand_state(B3)
            for dn, dt in dts:
                for nn, nz in (("noise", {"noise": noise}),
                               ("hash", {"seed": 64})):
                    kw = dict(init_state=state, state_snapshot_at=T3 // 3,
                              compute_dtype=dt, **nz)
                    old = cg.generate_materialized(core, mu, au, mode, **kw,
                                                   _legacy=True)
                    exact[f"b3_{B3}x{T3}_{dn}_{nn}"] = same(
                        cg.generate_materialized(core, mu, au, mode, **kw),
                        old)
                    if B3 == 3 and dn == "f32" and nn == "noise":
                        kw.pop("compute_dtype")
                        hold_old("b3_3x1000_f32", old,
                                 cg.generate_materialized_ref(core, mu, au,
                                                              mode, **kw))
            if B3 == 10:
                y, st = cg.generate_materialized(core, mu, au, mode,
                                                 noise=noise)
                y1, st1 = cg.generate_materialized(
                    core, mu[:, :1000], au[:, :1000], mode,
                    noise=cut(noise, 0, 1000))
                y2, st2 = cg.generate_materialized(
                    core, mu[:, 1000:], au[:, 1000:], mode,
                    noise=cut(noise, 1000, 2000), init_state=st1)
                exact["b3_chained_1000_equal_one_launch"] = (
                    same(torch.cat([y1, y2], dim=1), y) and same(st2, st))
        # ---- many rows: more than one row a sampling block, and the
        # per-row regions in device memory where the plan moves them ----
        many = {}
        for nb, dn, dt in ((128, "bf16", bf16), (128, "f32", f32),
                           (500, "bf16", bf16)):
            fr = torch.rand(2 + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            a2 = (core, fr, phi, geo.hop, -geo.d_lo, 2, mode)
            exact[f"b1_{nb}_rows_{dn}_hash"] = same(
                cg.generate_fused(*a2, seed=65, compute_dtype=dt),
                cg.generate_fused(*a2, seed=65, compute_dtype=dt,
                                  _legacy=True))
            many[f"b1_{nb}_rows_{dn}"] = cg.resident_plan(
                R, FC, 30, A, 80, nb, sms, dt, geo.K).rows_global
        state = rand_state(200)
        fr = torch.rand(2 + geo.K - 1, 200, frames.shape[2],
                        generator=gen).to(dev)
        a2 = (core, fr, phi, geo.hop, -geo.d_lo, 2, mode)
        kw = dict(seed=66, init_state=state, state_snapshot_at=300,
                  compute_dtype=f32)
        exact["b4b_200_rows_f32_snapshot_300"] = same(
            cg.generate_fused_with_state(*a2, **kw),
            cg.generate_fused_with_state(*a2, **kw, _legacy=True))
        mu = torch.rand(200, 300, 80, generator=gen).to(dev)
        au = (torch.rand(200, 300, 4 * A, generator=gen) * 2 - 1).to(dev)
        kw = dict(seed=67, init_state=state, state_snapshot_at=100,
                  compute_dtype=f32)
        exact["b3_200x300_f32_hash"] = same(
            cg.generate_materialized(core, mu, au, mode, **kw),
            cg.generate_materialized(core, mu, au, mode, **kw, _legacy=True))
        many["b4b_b3_200_rows_f32"] = cg.resident_plan(
            R, FC, 30, A, 80, 200, sms, f32, geo.K).rows_global
        res["many_rows_per_row_regions_in_device_memory"] = many
    torch.cuda.synchronize()
    res["exact"] = exact
    res["old_body_vs_plain"] = old_plain
    res["old_body_vs_plain_ok"] = old_ok

    # ---- both bodies timed in turns, their outputs held equal too ----
    timing = {}
    with torch.no_grad():
        for nb, nc in ((1, 8), (10, 8), (32, 8), (50, 8), (128, 8),
                       (500, 2)):
            fr = torch.rand(nc + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            a8 = (core, fr, phi, geo.hop, -geo.d_lo, nc, mode)
            timing[f"b1_{nb}_rows_us_per_step"] = turns(
                lambda: cg.generate_fused(*a8, seed=5),
                lambda: cg.generate_fused(*a8, seed=5, _legacy=True),
                2 if nb < 128 else 1, 1e3 / (nc * geo.hop), same)
        timing["b1_main_ms"] = turns(
            lambda: cg.generate_fused(*margs, seed=5),
            lambda: cg.generate_fused(*margs, seed=5, _legacy=True), 1,
            same=same)
        state = rand_state(Bm)
        kw = dict(seed=5, init_state=state,
                  state_snapshot_at=cfg.voc.target + cfg.voc.overlap)
        timing["b4b_main_ms"] = turns(
            lambda: cg.generate_fused_with_state(*margs, **kw),
            lambda: cg.generate_fused_with_state(*margs, **kw, _legacy=True),
            1, same=same)
        mu, au = voc.upsample(pad(mels, (2, 2)))
        muf = fold_with_overlap(mu, cfg.voc.target, cfg.voc.overlap)
        auf = fold_with_overlap(au, cfg.voc.target, cfg.voc.overlap)
        T3 = muf.shape[1]
        for tag, (m3, a3) in (("b3_folds_ms", (muf, auf)),
                              ("b3_unbatched_ms", (mu[:, :T3].contiguous(),
                                                   au[:, :T3].contiguous()))):
            timing[tag] = turns(
                lambda: cg.generate_materialized(core, m3, a3, mode, seed=7),
                lambda: cg.generate_materialized(core, m3, a3, mode, seed=7,
                                                 _legacy=True), 1, same=same)
            timing[tag]["shape"] = list(m3.shape[:2])
        # ---- the per-stage split of a B1 step, block 0 ----
        clock = gpu_clocks()
        mhz = float(clock.split(" MHz")[0]) if " MHz" in clock else None
        split = {}
        for nb in (1, 10):
            fr = torch.rand(8 + geo.K - 1, nb, frames.shape[2],
                            generator=gen).to(dev)
            _, cyc, steps = cg.generate_fused_profiled(
                core, fr, phi, geo.hop, -geo.d_lo, 8, mode, seed=5)
            split[nb] = {st: {k: v / steps for k, v in kinds.items()}
                         for st, kinds in cyc.items() if st != "prologue"}
            split[nb]["step_cycles"] = sum(sum(k.values()) for k in
                                           split[nb].values())
            if mhz:
                split[nb]["step_us_at_sm_clock"] = (split[nb]["step_cycles"]
                                                    / mhz)
        res["split_cycles_per_step"] = split
        res["split_sm_clock"] = clock
    res["timing"] = timing
    res["faster"] = {k: v["new_faster"] for k, v in timing.items()}
    exact.update({f"timed_{k}": v["equal"] for k, v in timing.items()})
    res["old_body_max_abs_err"] = {
        "b1": max(old_plain["b1_MOL_f32_max_abs_err"],
                  old_plain["b1_RAW_f32_max_abs_err"]),
        "b4b": max(old_plain["b4b_MOL_f32_max_abs_err"],
                   old_plain["b4b_MOL_f32_state_max_abs_err"]),
        "b3": max(old_plain["b3_3x1000_f32_max_abs_err"],
                  old_plain["b3_3x1000_f32_state_max_abs_err"])}
    ok = all(exact.values()) and all(old_ok.values())
    emit("resident", ok=ok, tolerance=tol, **res)
    if not ok:
        raise AssertionError("resident: the resident body differs from the "
                             "original body's dense arm, or that arm from "
                             "its plain version")
    return res


def phase_b10(cfg, dev, voc, mel, tol):
    """B10, the loop on pre-projected streams, on the resident body
    (``ARM_V2``), at the full default Config: against the original body's
    arm (``_legacy=True``) bit for bit, float32 and bfloat16 weights with
    float32 and bfloat16 streams, MOL and RAW, injected noise and the
    counter hash, at 10 rows x 1,100 steps, 1 row and 200 rows (the per-row
    regions in device memory in float32, the streams read in place);
    against its plain version at 10 x 1,100 (float32 weights and streams
    within ``tol``; bfloat16 at least 99 % within 1e-3; the counter hash
    from a seed); ``generate_v2`` on the main mel upsampled and folded, its
    one launch counted on the resident body; then its kernel
    (``launch_v2`` on streams projected beforehand, the gather into the
    plan's order included) timed in turns with the original body's (new,
    old, old, new) at B3's two shapes (10 x 12,100 and 1 x 12,100), beside
    the resident B3 there, the entry point and the stream projections on
    their own, clocks read around each set; the per-stage split of a B10
    step at 1 and 10 rows; its plain version at the first shape. Returns
    the results."""
    import torch
    from wavernn_tpu_torch.config import WaveRNNConfig
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.ops import cuda_gen as cg
    from wavernn_tpu_torch.ops import cuda_gen2 as cg2
    from wavernn_tpu_torch.ops.fold import fold_with_overlap
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(8765)
    R, FC = cfg.voc.rnn_dims, cfg.voc.fc_dims
    A4 = 4 * cfg.voc.aux_dims
    res, oks, exact = {}, {}, {}
    with torch.no_grad():
        for mode in ("MOL", "RAW"):
            v = wr.WaveRNN(WaveRNNConfig(mode=mode), cfg.dsp)
            v.reset_parameters(gen)
            core = v.to(dev).eval().core_weights()
            NC = core["fc3.weight"].shape[0]
            nu = NC // 3 + 1 if mode == "MOL" else NC
            for B, T in ((10, 1100), (1, 1100), (200, 120)):
                mu = torch.rand(B, T, 80, generator=gen).to(dev)
                au = (torch.rand(B, T, A4, generator=gen) * 2 - 1).to(dev)
                u = cg.counter_uniforms(97, T, B, nu, mode == "MOL", dev)
                noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" \
                    else u
                for wn, wd in (("f32", f32), ("bf16", bf16)):
                    for sn, sd in (("f32", f32), ("bf16", bf16)):
                        for nn, nz in (("noise", {"noise": noise}),
                                       ("hash", {"seed": 98})):
                            if B != 10 and nn == "noise":
                                continue
                            kw = dict(compute_dtype=wd, stream_dtype=sd, **nz)
                            exact[f"{mode}_{B}x{T}_w{wn}_s{sn}_{nn}"] = \
                                same_out(cg2.generate_v2(core, mu, au, mode,
                                                         **kw),
                                         cg2.generate_v2(core, mu, au, mode,
                                                         _legacy=True, **kw))
                if B != 10:
                    continue
                got = cg2.generate_v2(core, mu, au, mode, noise=noise,
                                      compute_dtype=f32, stream_dtype=f32)
                ref = cg2.generate_v2_ref(core, mu, au, mode, noise=noise,
                                          stream_dtype=f32)
                chk, oks[mode] = check_b1_f32(f"{mode}_f32", got, ref, tol)
                res.update(chk)
                if mode != "MOL":
                    continue
                got = cg2.generate_v2(core, mu, au, mode, noise=noise)
                ref = cg2.generate_v2_ref(core, mu, au, mode, noise=noise,
                                          compute_dtype=bf16)
                chk, oks["bf16"] = check_b1_bf16(got, ref)
                res.update(chk)
                got = cg2.generate_v2(core, mu, au, mode, seed=2025,
                                      compute_dtype=f32, stream_dtype=f32)
                ref = cg2.generate_v2_ref(core, mu, au, mode, seed=2025,
                                          stream_dtype=f32)
                chk, oks["prng"] = check_b1_f32("prng", got, ref, tol)
                res.update(chk)
        res["check_shape"] = [10, 1100]
        # ---- the entry point on the main mel, upsampled and folded ----
        core, mode = voc.core_weights(), cfg.voc.mode
        mels = torch.as_tensor(mel)[None].to(dev)
        mu, au = voc.upsample(torch.nn.functional.pad(mels, (2, 2)))
        muf = fold_with_overlap(mu, cfg.voc.target, cfg.voc.overlap)
        auf = fold_with_overlap(au, cfg.voc.target, cfg.voc.overlap)
        torch.cuda.synchronize()
        zero_counts()
        y = cg2.generate_v2(core, muf, auf, mode, seed=7)
        torch.cuda.synchronize()
        launches = launch_counts()
        res["path"] = {"rows": muf.shape[0], "steps": muf.shape[1],
                       "launches": launches,
                       "finite": bool(y.isfinite().all()),
                       "abs_max": float(y.abs().max())}
        # ---- timed in turns with the original body's arm, beside B3 ----
        T = muf.shape[1]
        timing = {}
        for tag, (m, a) in (("folds", (muf, auf)),
                            ("unbatched", (mu[:, :T].contiguous(),
                                           au[:, :T].contiguous()))):
            streams = cg2.v2_streams(core, m, a)

            def b10(legacy=False):
                return cg2.launch_v2(core, *streams, mode, seed=7,
                                     _legacy=legacy)
            tt = turns(b10, lambda: b10(True), 1, same=same_out)
            clk = [gpu_clocks()]
            b3_ms, _ = cuda_ms(lambda: cg.generate_materialized(
                core, m, a, mode, seed=7)[0], 1)
            call_ms, _ = cuda_ms(lambda: cg2.generate_v2(core, m, a, mode,
                                                         seed=7), 1)
            streams_ms, _ = cuda_ms(lambda: cg2.v2_streams(core, m, a), 2)
            clk.append(gpu_clocks())
            B = m.shape[0]
            fl, by = b10_work(B, T, R, FC, 30, 2, 2)
            b_ms, b_by = bound(fl, by, PEAK_BF16)
            k10 = min(tt["new"])
            timing[tag] = {"B": B, "steps": T, "turns_ms": tt, "ms": k10,
                           "legacy_ms": min(tt["old"]), "b3_ms": b3_ms,
                           "b10_call_ms": call_ms, "streams_ms": streams_ms,
                           "us_per_step_b10": 1e3 * k10 / T,
                           "us_per_step_legacy": 1e3 * min(tt["old"]) / T,
                           "us_per_step_b3": 1e3 * b3_ms / T,
                           "b10_over_b3": k10 / b3_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "flops": fl, "bytes": by,
                           "clocks": clk}
            exact[f"timed_{tag}"] = tt["equal"]
            if tag == "folds":
                # the plain version on the same streams and seed, at the
                # numbers the kernel multiplies
                p_ms, ref = once_ms(lambda: cg2.generate_v2_ref(
                    core, m, a, mode, seed=7, compute_dtype=bf16))
                chk, ok_t = check_b1_bf16(b10(), ref)
                timing[tag].update(plain_ms=p_ms, check=chk)
            else:
                got = b10()
                ok_t = bool(got.isfinite().all() and got.abs().max() <= 1)
            timing[tag]["ok"] = ok_t
        res["timing"] = timing
        res["faster"] = {k: v["turns_ms"]["new_faster"]
                         for k, v in timing.items()}
        # ---- the per-stage split of a B10 step, block 0 ----
        clock = gpu_clocks()
        mhz = float(clock.split(" MHz")[0]) if " MHz" in clock else None
        split = {}
        for nb in (1, 10):
            st = cg2.v2_streams(core, muf[:nb, :2200].contiguous(),
                                auf[:nb, :2200].contiguous())
            _, cyc, steps = cg2.generate_v2_profiled(core, *st, mode, seed=5)
            split[nb] = {k: {kd: c / steps for kd, c in kinds.items()}
                         for k, kinds in cyc.items() if k != "prologue"}
            split[nb]["step_cycles"] = sum(sum(k.values()) for k in
                                           split[nb].values())
            if mhz:
                split[nb]["step_us_at_sm_clock"] = (split[nb]["step_cycles"]
                                                    / mhz)
        res["split_cycles_per_step"] = split
        res["split_sm_clock"] = clock
    res["exact"] = exact
    res["max_abs_err"] = max(res["MOL_f32_max_abs_err"],
                             res["RAW_f32_max_abs_err"],
                             res["prng_max_abs_err"])
    ok = (all(oks.values()) and all(exact.values())
          and all(t["ok"] for t in timing.values())
          and launches["sample_loop_resident_v2"] == 1
          and sum(launches.values()) == 1
          and res["path"]["finite"] and res["path"]["abs_max"] <= 1.0)
    emit("b10", ok=ok, tolerance=tol, **res)
    if not ok:
        raise AssertionError("b10: B10 disagrees with the original body or "
                             "its plain version, or its entry point did not "
                             "launch it")
    return res


# ---- mesh: the multi-device paths (parallel/mesh.py) ----

# the two-rank runs' batches: 16 rows a rank; the TF step's text, frames
# and r
MESH_VOC_B = 32
MESH_TF = (32, 60, 140, 7)    # B, T_text, frames, r
MESH_LANES = 8
MESH_STEPS = 400              # the decode bound of tts_to_wav_batch
# data-parallel steps against one process: every loss and the first
# step's grad norm within 1e-4 relative (the gradients are averaged in
# another order, B5 and B6 run at 16 rows instead of 32, and BatchNorm sums
# its statistics over the ranks); the later steps' grad norms within 2e-3:
# Adam's first update moves a weight by about lr whatever its gradient's
# size, so a gradient whose sign flips on rounding (a Tacotron step's ReLU,
# max-pool and L1 branches, branch_grads) moves that weight by 2 lr
# between the two runs, and the next gradient carries it. The phase
# reports the one process against itself on the batch's rows in reverse
# order beside it
DP_TOL = 1e-4
DP_TOL_LATER = 2e-3
# tts_to_wav_batch(mesh): B8 decodes each rank's group at its own batch
# size, whose items differ from the whole batch's, so the sums reorder:
# the mels within 2e-3 (b8's tolerance), n_valid equal
MESH_MEL_TOL = 2e-3
MESH_TIMEOUT_S = 420


def mesh_counts():
    """Launch counts of every kernel a mesh path runs (launch_counts, B5's
    and B6's)."""
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    return {**launch_counts(), **b5_counts(), **tf_counts(ct)}


def zero_mesh_counts():
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    zero_counts()
    zero_b5()
    zero_tf_counts(ct)


def mesh_inputs(cfg, voc, tts, mel, work):
    """What every rank and the one-device references share, written to
    ``work/inputs.pt``: the weights, the main mel, the five sentences'
    decoded mels, the lanes' mels and the training batches (numpy from
    seeds)."""
    import numpy as np
    import torch
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.text import text_to_sequence
    five = SENTENCES[:5]
    seqs = [text_to_sequence(t, cfg.tts.cleaner_names) for t in five]
    decoded = taco.generate_batch(tts, seqs, 2, steps=MESH_STEPS,
                                  device=next(tts.parameters()).device)
    rng = np.random.RandomState(31)
    B, T_text, frames, r = MESH_TF
    seq = cfg.voc_train.seq_len
    win = seq // cfg.dsp.hop_length + 2 * cfg.voc.pad
    inp = {"voc": {k: v.cpu() for k, v in voc.state_dict().items()},
           "tts": {k: v.cpu() for k, v in tts.state_dict().items()},
           "mel": np.asarray(mel, np.float32),
           "five": five,
           "five_mels": [np.clip((lin + 4.0) / 8.0, 0.0, 1.0)
                         .astype(np.float32) for _, lin, _ in decoded],
           "lanes": [np.asarray(mel, np.float32)[:, 9 * b:9 * b + 26]
                     for b in range(MESH_LANES)],
           "voc_batch": (rng.uniform(-1, 1, (MESH_VOC_B, seq))
                         .astype(np.float32),
                         rng.uniform(-1, 1, (MESH_VOC_B, seq))
                         .astype(np.float32),
                         rng.uniform(0, 1, (MESH_VOC_B, 80, win))
                         .astype(np.float32)),
           "tf_batch": (rng.randint(1, 148, (B, T_text)),
                        rng.uniform(-4, 4, (B, 80, frames))
                        .astype(np.float32))}
    torch.save(inp, work / "inputs.pt")
    return inp


def _mesh_models(cfg, inp, dev):
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.models import wavernn as wr
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.load_state_dict(inp["voc"], strict=True)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.load_state_dict(inp["tts"], strict=True)
    return voc.to(dev).eval(), tts.to(dev).eval()


def mesh_serve(cfg, inp, dev, mesh, cases):
    """The serving paths, on ``mesh`` or (None) on one device, each with
    its own seed, the launch counts zeroed before it and read after it:
    {case: (output, counts, seconds)}. Outputs on the host: the waves as
    the paths return them on the device, bit for bit."""
    import torch
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.parallel import gen_sharded as gs
    from wavernn_tpu_torch.streaming import MultiStreamVocoder
    from wavernn_tpu_torch.synthesis import tts_to_wav_batch
    voc, tts = _mesh_models(cfg, inp, dev)
    mel = torch.as_tensor(inp["mel"])[None].to(dev)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def streams():
        msv = MultiStreamVocoder(voc, MESH_LANES, chunk_frames=24,
                                 generator=gen(24), device=dev,
                                 device_out=True, mesh=mesh)
        for b, m in enumerate(inp["lanes"]):
            msv.feed(b, m, drain=False)
        out = msv.poll()               # one 24-frame block of 8 lanes
        return [torch.cat(out[b]) for b in range(MESH_LANES)]

    def multi():
        if mesh is None:
            return wr.generate_multi(voc, inp["five_mels"], generator=gen(23),
                                     device=dev, device_out=True)
        return gs.generate_multi_sharded(voc, inp["five_mels"], mesh,
                                         generator=gen(23), device=dev,
                                         device_out=True)

    runs = {
        "crossfade": lambda: gs.generate_sharded(
            voc, mel, mesh=mesh, generator=gen(21), device=dev,
            device_out=True),
        "seam": lambda: gs.generate_sharded(
            voc, mel, mesh=mesh, seam_passes=2, generator=gen(22),
            device=dev, device_out=True),
        "multi": multi, "streams": streams,
        "tts": lambda: tts_to_wav_batch(
            tts, voc, inp["five"], cfg, 2, steps=MESH_STEPS,
            generator=gen(25), device=dev, mesh=mesh)}
    out = {}
    for name in cases:
        torch.cuda.synchronize()
        zero_mesh_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = runs[name]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = mesh_counts()
        if name == "tts":
            got = [(w, m) for w, m in got]
        elif isinstance(got, list):
            got = [g.cpu() for g in got]
        else:
            got = got.cpu()
        out[name] = (got, counts, wall)
        if name == "crossfade":
            out["crossfade_stats"] = dict(gs.last_stats)
    return out


def mesh_train(cfg, inp, dev, mesh, reverse=False):
    """3 vocoder steps and 2 Tacotron teacher-forcing steps, data parallel
    on ``mesh`` (this rank's rows of the batches) or on one device (all of
    them): {model: (losses, grad norms, step seconds, counts)}.
    ``reverse`` (one device): the same steps on the batches' rows in
    reverse order, with the same dropout and zoneout draws reversed too,
    reported beside the comparison (DP_TOL)."""
    import torch
    from wavernn_tpu_torch.models import tacotron as taco
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.parallel.mesh import rank, size
    from wavernn_tpu_torch.train import tacotron_train as tt
    from wavernn_tpu_torch.train import wavernn_train as wt
    k, n = (0, 1) if mesh is None else (rank(mesh), size(mesh))

    def rows(a):
        per = a.shape[0] // n
        t = torch.as_tensor(a[k * per:(k + 1) * per]).to(dev)
        return t.flip(0) if reverse else t

    out = {}
    voc = wr.WaveRNN(cfg.voc, cfg.dsp)
    voc.load_state_dict(inp["voc"], strict=True)
    voc = voc.to(dev)
    st = wt.TrainState(voc, wt.make_optimizer(voc, cfg.voc_train.lr,
                                              cfg.voc_train.clip_grad_norm),
                       0)
    x, y, m = (rows(a) for a in inp["voc_batch"])
    out["vocoder"] = _mesh_steps(lambda: wt.train_step(
        st, x, y, m, cfg.voc, mesh=mesh), 3)
    tts = taco.Tacotron(cfg.tts, 80)
    tts.load_state_dict(inp["tts"], strict=True)
    tts = tts.to(dev)
    r = MESH_TF[3]
    tts.decoder.r.fill_(r)
    ts = tt.TTSTrainState(tts, wt.make_optimizer(tts, 1e-3, 1.0), 0)
    ids, mm = (rows(a) for a in inp["tf_batch"])
    g = torch.Generator(device=dev).manual_seed(32)

    def masks():
        """None: drawn by the step; reversed: the draws the step would
        make, in reverse row order."""
        if not reverse:
            return None
        d = taco.draw_masks(tts, ids.shape[0], ids.shape[1],
                            mm.shape[2] // r, g, dev)
        return {k: v.flip(0) if k.startswith("enc") else v.flip(1)
                for k, v in d.items()}
    out["tacotron_tf"] = _mesh_steps(lambda: tt.train_step_tf(
        ts, ids, mm, r, masks=masks(), generator=g, mesh=mesh), 2)
    return out


def _mesh_steps(step, n):
    import torch
    zero_mesh_counts()
    losses, norms, secs = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step()
        losses.append(float(res["loss"]))
        norms.append(float(res["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    return losses, norms, secs, mesh_counts()


def mesh_child(rank, world, port, work, backend, serve_cases, train):
    """One rank of a mesh run (torch.multiprocessing): joins the group
    (NCCL, one card a rank; or gloo, every rank on card 0), runs the cases
    on the mesh and saves its results to work/<backend>_rank<r>.pt."""
    import datetime
    import os
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.parallel.mesh import make_mesh
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if backend == "nccl" else 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300), **kw)
    try:
        mesh = make_mesh()
        inp = torch.load(work / "inputs.pt", weights_only=False)
        cfg = Config()
        res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "device": str(dev),
               "serve": mesh_serve(cfg, inp, dev, mesh, serve_cases)}
        if train:
            res["train"] = mesh_train(cfg, inp, dev, mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, work / f"{backend}_rank{rank}.pt")


def run_ranks(world, work, backend, serve_cases, train):
    """Spawn ``world`` ranks of mesh_child and wait for them (at most
    MESH_TIMEOUT_S, then they are killed); returns their results in rank
    order. Any rank's failure raises."""
    import socket
    import torch
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(mesh_child, args=(world, port, work, backend,
                                               serve_cases, train),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks ({backend}) still running "
                                   f"after {MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(work / f"{backend}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _same_out(a, b):
    """Bit for bit, through lists and (wave, mel) pairs."""
    import numpy as np
    import torch
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_out(x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.shape == b.shape and bool(torch.equal(a, b))
    return a.shape == b.shape and bool(np.array_equal(a, b))


def _max_diff(a, b):
    import numpy as np
    if isinstance(a, (list, tuple)):
        return max(_max_diff(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


# the kernels each serving path launches on every rank (resident bodies;
# none on the original ones)
MESH_KERNELS = {"crossfade": ("sample_loop_resident",),
                "seam": ("sample_loop_resident_state",),
                "multi": ("sample_loop_resident",),
                "streams": ("sample_loop_resident_mat",),
                "tts": ("sample_loop_resident", "gru_res_fwd",
                        "taco_decode_batch")}
MESH_LEGACY = ("sample_loop_old_dense", "sample_loop_sparse",
               "taco_decode_legacy", "taco_decode_batch_legacy",
               "gru_seq_fwd_legacy", "gru_seq_bwd_legacy",
               "taco_tf_legacy_fwd", "taco_tf_legacy_bwd")


def phase_mesh(cfg, dev, voc, tts, mel, smi):
    """(a) one NCCL rank per card (at most 4): generate_sharded's mesh
    path on the main mel, bit for bit the one-device call's; (b) two ranks
    sharing card 0 over gloo, at the full default Config: the crossfade
    and the exact seams of generate_sharded, generate_multi_sharded on
    the five sentences' mels, MultiStreamVocoder with 8 lanes over one
    24-frame block, each bit for bit the one-device call with the same
    seed, every rank's launches on the resident bodies; tts_to_wav_batch
    on the five sentences (mels within MESH_MEL_TOL, n_valid equal, waves
    finite and within sqrt(2)); 3 data-parallel vocoder steps at batch 32
    x 1375 and 2 Tacotron TF steps at batch 32 (16 rows a rank) against
    one process at batch 32 (DP_TOL, DP_TOL_LATER),
    with B5's and B6's launches a rank and the steps/s of two processes
    that share one card (not a scaling figure). Returns the phase's
    results."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mesh_"))
    try:
        inp = mesh_inputs(cfg, voc, tts, mel, work)
        serve_cases = ("crossfade", "seam", "multi", "streams", "tts")
        want = mesh_serve(cfg, inp, dev, None, serve_cases)
        want_train = mesh_train(cfg, inp, dev, None)
        floor_train = mesh_train(cfg, inp, dev, None, reverse=True)
        world_a = min(torch.cuda.device_count(), 4)
        ranks_a = run_ranks(world_a, work, "nccl", ("crossfade",), False)
        ranks_b = run_ranks(2, work, "gloo", serve_cases, True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    res = {"nvidia_smi": smi}
    a = {"world": world_a,
         "backends": [r["backend"] for r in ranks_a],
         "devices": [r["device"] for r in ranks_a],
         "equal_one_device": [_same_out(r["serve"]["crossfade"][0],
                                        want["crossfade"][0])
                              for r in ranks_a],
         "launches_per_rank": [r["serve"]["crossfade"][1]
                               ["sample_loop_resident"] for r in ranks_a],
         "last_stats": ranks_a[0]["serve"]["crossfade_stats"]}
    ok_a = (all(b == "nccl" for b in a["backends"])
            and all(a["equal_one_device"])
            and all(n >= 1 for n in a["launches_per_rank"]))
    emit("mesh", case="nccl_generate_sharded", ok=ok_a, **a)

    oks = {"nccl": ok_a}
    serve = {}
    for name in serve_cases:
        got = [r["serve"][name] for r in ranks_b]
        counts = [c for _, c, _ in got]
        ran = all(c[k] >= 1 for c in counts for k in MESH_KERNELS[name])
        legacy = sum(c[k] for c in counts for k in MESH_LEGACY)
        row = {"launches_per_rank": [{k: c[k] for k in MESH_KERNELS[name]}
                                     for c in counts],
               "legacy_launches": legacy,
               "ranks_equal": _same_out(got[0][0], got[1][0]),
               "wall_s_per_rank": [w for _, _, w in got],
               "one_device_wall_s": want[name][2]}
        if name == "tts":
            w_one = want[name][0]
            mels = [m for _, m in got[0][0]]
            row["n_valid"] = [m.shape[1] for m in mels]
            row["n_valid_one_device"] = [m.shape[1] for _, m in w_one]
            row["mel_max_abs_diff"] = _max_diff(mels, [m for _, m in w_one])
            row["wav_abs_max"] = max(float(np.abs(w).max())
                                     for w, _ in got[0][0])
            ok = (row["ranks_equal"] and ran and not legacy
                  and row["n_valid"] == row["n_valid_one_device"]
                  and row["mel_max_abs_diff"] <= MESH_MEL_TOL
                  and all(bool(np.isfinite(w).all()) for w, _ in got[0][0])
                  and row["wav_abs_max"] <= math.sqrt(2) + 1e-6)
        else:
            row["equal_one_device"] = _same_out(got[0][0], want[name][0])
            row["max_abs_diff_one_device"] = _max_diff(got[0][0],
                                                       want[name][0])
            ok = row["ranks_equal"] and row["equal_one_device"] and ran \
                and not legacy
        serve[name] = row
        oks[name] = ok
        emit("mesh", case=f"gloo_{name}", ok=ok, tolerance=(
            MESH_MEL_TOL if name == "tts" else "bit for bit"), **row)
    res["nccl"], res["serve"] = a, serve
    res["crossfade_stats"] = ranks_b[0]["serve"]["crossfade_stats"]

    train = {}
    want_b5 = {"vocoder": ("gru_res_fwd", "gru_res_bwd"),
               "tacotron_tf": ("gru_res_fwd", "gru_res_bwd",
                               "taco_tf_res_fwd", "taco_tf_res_bwd")}
    for model, kernels in want_b5.items():
        got = [r["train"][model] for r in ranks_b]
        losses, norms, secs, _ = got[0]
        w_losses, w_norms, w_secs, _ = want_train[model]
        f_losses, f_norms = floor_train[model][:2]
        rels = [abs(g - w) / abs(w) for g, w in zip(losses + norms,
                                                    w_losses + w_norms)]
        tols = ([DP_TOL] * len(losses) + [DP_TOL]
                + [DP_TOL_LATER] * (len(norms) - 1))
        rel = max(rels)
        counts = [c for _, _, _, c in got]
        row = {"losses": losses, "grad_norms": norms,
               "one_process_losses": w_losses,
               "one_process_grad_norms": w_norms, "max_rel_diff": rel,
               "reversed_rows_losses": f_losses,
               "reversed_rows_grad_norms": f_norms,
               "reversed_rows_max_rel_diff": max(
                   abs(f - w) / abs(w) for f, w in zip(f_losses + f_norms,
                                                       w_losses + w_norms)),
               "rel_diffs": rels, "tolerances": tols,
               "within": [r <= t for r, t in zip(rels, tols)],
               "ranks_equal": all(g[:2] == got[0][:2] for g in got),
               "launches_per_rank": [{k: c[k] for k in kernels}
                                     for c in counts],
               "legacy_launches": sum(c[k] for c in counts
                                      for k in MESH_LEGACY),
               "steps_per_s_two_processes_one_card": (
                   (len(secs) - 1) / sum(secs[1:])),
               "steps_per_s_one_process": (len(w_secs) - 1) / sum(w_secs[1:]),
               "note": "two processes sharing one card: not a scaling "
                       "figure"}
        ok = (all(row["within"]) and row["ranks_equal"]
              and not row["legacy_launches"]
              and all(c[k] >= 1 for c in counts for k in kernels)
              and all(math.isfinite(v) for v in losses + norms))
        train[model] = row
        oks[f"train_{model}"] = ok
        emit("mesh", case=f"gloo_train_{model}", ok=ok, **row)
    res["train"] = train
    res["seconds"] = time.perf_counter() - t_phase
    res["ok"] = all(oks.values())
    emit("mesh", case="summary", ok=res["ok"], oks=oks,
         seconds=res["seconds"], nvidia_smi=smi)
    if not res["ok"]:
        raise AssertionError(f"mesh: a case failed: "
                             f"{[k for k, v in oks.items() if not v]}")
    return res


def a12_signal(n: int, sr: int, seed: int):
    """A seeded voiced-like float32 signal of ``n`` samples: four harmonics
    of a vibrato'd fundamental (90-300 Hz), a slow amplitude swell and a
    little noise, peak below 1."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 300)
    phase = 2 * np.pi * (f0 + 60 * np.sin(2 * np.pi * 0.7 * t)) * t
    y = sum(0.25 / k * np.sin(k * phase) for k in range(1, 5))
    y = y * (0.6 + 0.4 * np.sin(2 * np.pi * 2.3 * t) ** 2)
    return (y + 0.005 * rng.randn(n)).astype(np.float32)


def phase_a12(cfg, dev, tts):
    """The analysis side on the card at the full default Config (module
    docstring, ``a12``). Returns the results."""
    import contextlib
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from scipy.io import wavfile
    from wavernn_tpu_torch.cli import gen_tacotron, gen_wavernn, \
        preprocess, train_wavernn
    from wavernn_tpu_torch.cli.common import make_workspace
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.dsp import (griffinlim, mel_to_stft,
                                       melspectrogram, melspectrogram_np,
                                       reconstruct_waveform, save_wav)
    from wavernn_tpu_torch.dsp.audio import load_wav
    from wavernn_tpu_torch.dsp.mel import db_to_amp, denormalize
    from wavernn_tpu_torch.train.checkpoints import save_checkpoint
    from wavernn_tpu_torch.train.wavernn_train import make_optimizer
    t_phase = time.perf_counter()
    sr, hop = cfg.dsp.sample_rate, cfg.dsp.hop_length
    res, oks = {"card": smi_line()}, {}
    text = SENTENCES[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_a12_") as tmp:
        tmp = Path(tmp)
        wavs = tmp / "corpus" / "wavs"
        wavs.mkdir(parents=True)
        rng = np.random.RandomState(15)
        rows = []
        for i in range(A12_WAVS):
            n = int(sr * rng.uniform(1.5, 3.0))
            save_wav(a12_signal(n, sr, 100 + i), wavs / f"a12_{i:03d}.wav",
                     sr)
            rows.append(f"a12_{i:03d}|{SENTENCES[i % len(SENTENCES)]}")
        (tmp / "corpus" / "metadata.csv").write_text("\n".join(rows) + "\n")
        hp = tmp / "hparams_a12.py"
        hp.write_text(f"wav_path = {str(wavs)!r}\n"
                      f"data_path = {str(tmp / 'data')!r}\n"
                      "voc_model_id = 'a12'\ntts_model_id = 'a12'\n"
                      f"voc_total_steps = {A12_STEPS}\n"
                      "voc_checkpoint_every = 1000\nvoc_test_samples = 2\n")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                preprocess.main(["--hp_file", str(hp), "--num_workers", "4"])
            res["preprocess_s"] = time.perf_counter() - t0
            data = tmp / "data"
            n_mel = len(list((data / "mel").glob("*.npy")))
            n_quant = len(list((data / "quant").glob("*.npy")))
            oks["preprocess"] = (n_mel == n_quant == A12_WAVS
                                 and (data / "dataset.pkl").is_file()
                                 and (data / "text_dict.pkl").is_file()
                                 and "Completed." in out.getvalue())
            res["dataset_items"] = n_mel
            # the vocoder trained on the port's own dataset
            zero_b5()
            t0 = time.perf_counter()
            train_wavernn.main(["--hp_file", str(hp)])
            torch.cuda.synchronize()
            res["train_wall_s"] = time.perf_counter() - t0
            res["train_launches"] = b5_counts()
            ckpt = tmp / "checkpoints" / "a12.wavernn"
            epochs = [r for r in map(json.loads, (ckpt / "metrics.jsonl")
                                     .read_text().splitlines())
                      if r["event"] == "epoch"]
            res["train_steps"] = [r["step"] for r in epochs]
            res["train_loss"] = [r["loss"] for r in epochs]
            oks["train"] = (res["train_steps"][-1:] == [A12_STEPS]
                            and all(math.isfinite(v)
                                    for v in res["train_loss"])
                            and b5_on_resident(res["train_launches"],
                                               2 * A12_STEPS, 2 * A12_STEPS))
            # a .wav through the vocoder: B1 once, fold-batched
            wav0 = wavs / "a12_000.wav"
            out_dir = tmp / "model_outputs" / "a12.wavernn"
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                gen_wavernn.main(["--hp_file", str(hp), "--file", str(wav0)])
            torch.cuda.synchronize()
            res["gen_wavernn_wall_s"] = time.perf_counter() - t0
            c = launch_counts()
            res["gen_wavernn_launches"] = c
            got = sorted(out_dir.glob("__a12_000__*gen_batched*.wav"))
            frames = melspectrogram_np(load_wav(wav0, sr), cfg.dsp).shape[1]
            pcm = wavfile.read(got[0])[1] if got else np.zeros(0)
            oks["gen_wavernn_file"] = (
                c["sample_loop_resident"] == 1 and c["sample_loop_fused"] == 1
                and c["sample_loop_old_dense"] == 0
                and (out_dir / "__a12_000__0k_steps_target.wav").is_file()
                and pcm.shape == ((frames - 1) * hop,)
                and int(np.abs(pcm.astype(int)).max()) > 0)
            # text -> Griffin-Lim wav with the attention png, no vocoder
            cli_cfg = Config.from_hparams_file(hp)
            ws = make_workspace(cli_cfg)
            save_checkpoint("tts", ws, tts, make_optimizer(tts, 1e-3), 1000,
                            r=2, log=lambda *_: None)
            zero_counts()
            zero_b5()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                gen_tacotron.main(["--hp_file", str(hp), "-a", "-i", text,
                                   "griffinlim", "--iters", "32"])
            torch.cuda.synchronize()
            res["gen_tacotron_gl_wall_s"] = time.perf_counter() - t0
            c = launch_counts()
            res["gen_tacotron_gl_launches"] = c
            stem = f"__input_{text[:10]}_griffinlim_1k.wav"
            gl_wav = ws.tts_output / stem
            png = ws.tts_output / f"{stem}.png"
            pcm = wavfile.read(gl_wav)[1] if gl_wav.is_file() else np.zeros(0)
            res["gen_tacotron_gl_samples"] = int(pcm.size)
            oks["gen_tacotron_griffinlim"] = (
                c["taco_decode"] == 1 and c["gru_res_fwd"] == 4
                and c["gru_seq_fwd_legacy"] == 0
                and c["taco_decode_legacy"] == 0
                and c["taco_decode_batch"] == 0
                and c["sample_loop_fused"] == 0
                and c["sample_loop_materialized"] == 0
                and pcm.size > 0 and int(np.abs(pcm.astype(int)).max()) > 0
                and png.is_file()
                and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n")
        finally:
            os.chdir(cwd)

    # reconstruct_waveform on the card against the port's CPU run
    y = a12_signal((A12_FRAMES - 1) * hop, sr, 7)
    mel = melspectrogram_np(y, cfg.dsp)
    u = torch.rand((cfg.dsp.n_fft // 2 + 1, mel.shape[1]),
                   generator=torch.Generator().manual_seed(0))
    amp = torch.as_tensor(db_to_amp(denormalize(mel.astype(np.float64))),
                          dtype=torch.float32)
    S_cpu = mel_to_stft(amp, cfg.dsp)
    S_dev = mel_to_stft(amp.to(dev), cfg.dsp)
    nnls_err = float((S_dev.cpu() - S_cpu).abs().max() / S_cpu.abs().max())
    g4_cpu = griffinlim(S_cpu, cfg.dsp, n_iter=4, phase_u=u)
    u_dev = u.to(dev)
    g4_dev = griffinlim(S_cpu.to(dev), cfg.dsp, n_iter=4, phase_u=u_dev)
    gl4_err = float((g4_dev.cpu() - g4_cpu).abs().max() / g4_cpu.abs().max())
    t0 = time.perf_counter()
    w_cpu = reconstruct_waveform(mel, cfg.dsp, n_iter=32, device="cpu",
                                 phase_u=u)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    clk = [gpu_clocks()]
    gl_ms, w_dev = cuda_ms(lambda: reconstruct_waveform(
        mel, cfg.dsp, n_iter=32, device=dev, phase_u=u), 5)
    # its two stages alone, on the device's amplitude and magnitude
    amp_dev = amp.to(dev)
    nnls_ms, _ = cuda_ms(lambda: mel_to_stft(amp_dev, cfg.dsp), 5)
    gl32_ms, _ = cuda_ms(lambda: griffinlim(S_dev, cfg.dsp, n_iter=32,
                                            phase_u=u_dev), 5)
    clk.append(gpu_clocks())
    d = (w_dev - w_cpu).astype(np.float64)
    rms = float(np.sqrt(np.mean(w_cpu.astype(np.float64) ** 2)))
    gl_rms_err = float(np.sqrt(np.mean(d ** 2))) / rms
    oks["reconstruct_waveform"] = (
        w_dev.shape == w_cpu.shape == ((A12_FRAMES - 1) * hop,)
        and bool(np.isfinite(w_dev).all()) and nnls_err <= A12_NNLS_TOL
        and gl4_err <= A12_GL4_TOL and gl_rms_err <= A12_GL_RMS_TOL)
    res["griffinlim"] = {
        "frames": int(mel.shape[1]), "n_iter": 32, "nnls_iters": 200,
        "ms": gl_ms, "nnls_ms": nnls_ms, "griffinlim_ms": gl32_ms,
        "cpu_plain_ms": cpu_ms, "clocks": clk,
        "nnls_rel_err": nnls_err, "nnls_tol": A12_NNLS_TOL,
        "gl4_rel_err": gl4_err, "gl4_tol": A12_GL4_TOL,
        "gl32_max_abs_err": float(np.abs(d).max()),
        "gl32_rms_rel_err": gl_rms_err, "gl32_rms_tol": A12_GL_RMS_TOL,
        "wav_abs_max": float(np.abs(w_dev).max())}
    # melspectrogram of 10 s on the card against the host's numpy mel
    y10 = torch.from_numpy(a12_signal(10 * sr, sr, 8))
    y10_dev = y10.to(dev)
    mel_ms, m_dev = cuda_ms(lambda: melspectrogram(y10_dev, cfg.dsp,
                                                   device=dev), 20)
    t0 = time.perf_counter()
    m_np = melspectrogram_np(y10.numpy(), cfg.dsp)
    np_ms = 1e3 * (time.perf_counter() - t0)
    mel_err = float(np.abs(m_dev.cpu().numpy() - m_np).max())
    oks["melspectrogram"] = (tuple(m_dev.shape) == m_np.shape
                             and mel_err <= 5e-4)
    res["melspectrogram"] = {"seconds_of_audio": 10, "frames": m_np.shape[1],
                             "ms": mel_ms, "numpy_ms": np_ms,
                             "max_abs_err": mel_err, "tol": 5e-4}
    res["oks"] = oks
    res["seconds"] = time.perf_counter() - t_phase
    ok = all(oks.values())
    emit("a12", ok=ok, **res)
    if not ok:
        raise AssertionError("a12: " + ", ".join(k for k, v in oks.items()
                                                 if not v))
    return res


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
    zero_counts()
    timings = {}
    t0 = time.perf_counter()
    wav, mel, attn = tts_to_wav(tts, voc, text, cfg, r, steps=steps,
                                generator=torch.Generator().manual_seed(1),
                                device=dev, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = {k: counts[k] for k in ("sample_loop_fused",
                                       "sample_loop_resident", "taco_decode",
                                       "gru_res_fwd")}
    audio_s = len(wav) / cfg.dsp.sample_rate
    stages = elapsed_ms(timings)
    import numpy as np
    finite = bool(np.isfinite(wav).all())
    peak = float(np.abs(wav).max())
    # the postnet before (its BiGRU as a host-launched step loop, slices
    # 1-4) and after (on B5's forward kernel) on a decode's shape
    dm = torch.randn(1, 80, steps,
                     generator=torch.Generator().manual_seed(78)).to(dev)
    with torch.no_grad():
        postnet_ms = {eng: cuda_ms(lambda: taco.postnet(tts, dm, engine=eng),
                                   2)[0] for eng in ("scan", "kernel")}
    emit("main", text=text, text_ids=len(text_to_sequence(
        text, cfg.tts.cleaner_names)), mel_frames=int(mel.shape[1]),
         attn_shape=list(attn.shape), wav_samples=len(wav),
         audio_s=audio_s, wall_s=wall, x_realtime=audio_s / wall,
         stage_ms=stages, launches=launches, wav_finite=finite,
         wav_abs_max=peak, postnet_ms_plain_loop=postnet_ms["scan"],
         postnet_ms_b5=postnet_ms["kernel"])
    # folds' samples lie in [-1, 1]; the equal-power crossfade of two
    # folds can reach sqrt(2)
    if not (finite and peak <= math.sqrt(2) + 1e-9
            and all(launches.values())
            and counts["sample_loop_resident"] == counts["sample_loop_fused"]
            and counts["sample_loop_old_dense"] == 0
            and counts["sample_loop_materialized"] == 0
            and counts["gru_seq_fwd_legacy"] == 0
            and counts["taco_decode_legacy"] == 0
            and counts["taco_decode_batch_legacy"] == 0):
        raise AssertionError("main path: bad wave or a kernel never ran")

    # ---- b3, b8: the serving kernels against their plain versions; serve,
    # stream: the serving paths ----
    b3 = phase_b3(cfg, dev, torch.Generator().manual_seed(77), TOL)
    b8, b8_cases = phase_b8(cfg, dev, tts, MEL_TOL, ATT_TOL)
    b8res = phase_b8res(cfg, dev, tts, logs.get("taco_decode_resident", ""),
                        MEL_TOL, ATT_TOL)
    serve_counts = phase_serve(cfg, dev, tts, voc)
    stream_b3, stream = phase_stream(cfg, dev, voc, mel)

    # ---- b5: the GRU recurrence kernels against their plain versions ----
    b5 = {}
    T5, H5 = cfg.voc_train.seq_len, cfg.voc.rnn_dims
    zero_b5()
    for B5 in (32, 128):
        for dt in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                res, ok = check_b5(cuda_gru, *gru_inputs(T5, B5, H5, dt, dev,
                                                         B5))
            res["plan"] = [cuda_gru.resident_launch_plan(B5, H5, dt, bw)
                           for bw in (False, True)]
            tag = f"B{B5}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            b5[tag] = res
            emit("b5", case=tag, T=T5, H=H5, ok=ok,
                 tolerance=B5_BF16_TOL if dt == torch.bfloat16
                 else B5_F32_TOL, **res)
            if not ok:
                raise AssertionError(f"B5 {tag}: a kernel disagrees with its "
                                     "plain version")
    # every launch of the phase on the resident body
    if not b5_on_resident(b5_counts(), 4, 4):
        raise AssertionError(f"B5: launches off the resident body: "
                             f"{b5_counts()}")
    # ---- b5res: the resident B5 body against the first body ----
    b5res = phase_b5res(dev, logs.get("gru_resident", ""))

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
        zero_b5()
        t0 = time.perf_counter()
        try:
            train_wavernn.main(["--hp_file", str(hp)])
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        cli_s = time.perf_counter() - t0
        b5_launches = b5_counts()
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
               "regenerated_samples": int(wav.numel()), "wall_s": cli_s,
               "cli_steps_per_s": [r["steps_per_s"] for r in epochs]}
        ok = (cli["steps"] == list(range(1, TRAIN_STEPS + 1))
              and all(math.isfinite(v) for v in cli["epoch_loss"])
              and cli["nonfinite_grad_steps"] == 0
              and cli["nonfinite_loss_steps"] == 0
              and b5_on_resident(b5_launches, 2 * TRAIN_STEPS,
                                 2 * TRAIN_STEPS)
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
                              B5_KERNELS)
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

    # ---- prune: pruned vocoder training and its block-sparse serve ----
    prune = phase_prune(cfg, dev)

    # ---- b6: the TF decoder training recurrence against its plain versions
    from wavernn_tpu_torch.ops import cuda_taco_train as ct
    b6 = {}
    for tag, (Bq, Tq, Gq, rq), train in (("full", B6_FULL, True),
                                         ("odd", (5, 33, 7, 2), True),
                                         ("eval", B6_FULL, False)):
        ins, w6 = b6_case(Bq, Tq, Gq, rq, dev, 21, train)
        with torch.no_grad():
            res, ok = check_b6(ct, ins, w6, 22, backward=train)
        b6[tag] = res
        emit("b6", case=tag, B=Bq, T_text=Tq, G=Gq, r=rq, ok=ok,
             tolerance=B6_TOL, **res)
        if not ok:
            raise AssertionError(f"B6 {tag}: a kernel disagrees with its "
                                 "plain version")

    # ---- b6res: the resident B6 body against the original body ----
    b6res = phase_b6res(ct, dev, logs)

    # ---- b7: the AF decoder training recurrence against its plain versions
    b7 = {}
    for tag, (Bq, Tq, Gq, rq), train in (("full", B7_FULL, True),
                                         ("odd", (5, 33, 7, 2), True),
                                         ("eval", B7_FULL, False)):
        ins, w7 = b7_case(Bq, Tq, Gq, rq, dev, 41, train)
        with torch.no_grad():
            res, ok = check_b7(ct, ins, w7, 42, backward=train)
        b7[tag] = res
        emit("b7", case=tag, B=Bq, T_text=Tq, G=Gq, r=rq, ok=ok,
             tolerance=B6_TOL, **res)
        if not ok:
            raise AssertionError(f"B7 {tag}: a kernel disagrees with its "
                                 "plain version")
    # ---- b7res: the resident B7 body against the original body ----
    b7res = phase_b7res(ct, dev, logs.get("taco_train_resident", ""))

    # ---- taco_train: the Tacotron trainer's CLI at full width ----
    from wavernn_tpu_torch.cli import train_tacotron
    from wavernn_tpu_torch.config import TacotronTrainConfig
    from wavernn_tpu_torch.data.dataset import get_tts_datasets
    from wavernn_tpu_torch.train import tacotron_train as tt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_taco_") as tmp:
        tmp = Path(tmp)
        write_tts_dataset(tmp / "data", TT_ITEMS, 11)
        hp = tmp / "hparams_taco.py"
        hp.write_text(f"data_path = {str(tmp / 'data')!r}\n"
                      "tts_model_id = 'smoke'\n"
                      f"tts_schedule = {TT_SCHEDULE!r}\n"
                      "tts_checkpoint_every = 3\n")
        work = tmp / "run"
        work.mkdir()

        def cli(*flags, hp_file=hp):
            cwd = os.getcwd()
            os.chdir(work)
            try:
                train_tacotron.main(["--hp_file", str(hp_file), *flags])
                torch.cuda.synchronize()
            finally:
                os.chdir(cwd)

        zero_tf_counts(ct)
        zero_b5()
        t0 = time.perf_counter()
        cli()
        cli_s = time.perf_counter() - t0
        tt_launches = {**tf_counts(ct), **b5_counts()}
        ckpt = work / "checkpoints" / "smoke.tacotron"
        records = [json.loads(ln) for ln in
                   (ckpt / "metrics.jsonl").read_text().splitlines()]
        sessions = [r for r in records if r["event"] == "session"]
        files = {n: (ckpt / n).exists() for n in (
            "latest_weights.npz", "latest_optim.npz",
            "taco_step0K_weights.npz", "taco_step0K_optim.npz")}
        with np.load(ckpt / "latest_weights.npz") as z:
            meta = {"step": int(z["meta/step"]), "r": int(z["meta/r"])}
        n_steps_tt = TT_SCHEDULE[-1][2]
        res = {"sessions": [[r["r"], r["step"], r["loss"]] for r in sessions],
               "nonfinite_loss_steps": sum(r["nonfinite_loss_steps"]
                                           for r in sessions),
               "nonfinite_grad_steps": sum(r["nonfinite_grad_steps"]
                                           for r in sessions),
               "launches": tt_launches, "files": files, "meta": meta,
               "wall_s": cli_s,
               "cli_steps_per_s": [r.get("steps_per_s") for r in sessions]}
        ok = ([r["r"] for r in sessions] == [7, 5]
              and [r["step"] for r in sessions] == [3, n_steps_tt]
              and all(math.isfinite(r["loss"]) for r in sessions)
              and res["nonfinite_loss_steps"] == 0
              and res["nonfinite_grad_steps"] == 0
              and on_resident(tt_launches, n_steps_tt, n_steps_tt)
              and b5_on_resident(tt_launches, 4 * n_steps_tt,
                                 4 * n_steps_tt)
              and all(files.values()) and meta == {"step": n_steps_tt, "r": 5})
        emit("taco_train", stage="cli", ok=ok, **res)
        if not ok:
            raise AssertionError("taco_train: the CLI run failed a check")

        # GTA mels and attention maps from that checkpoint: the eval TF
        # forward, a launch a batch of 8, on the resident body
        zero_tf_counts(ct)
        t0 = time.perf_counter()
        cli("--force_gta")
        cli("--force_attn")
        export_s = time.perf_counter() - t0
        export_launches = tf_counts(ct)
        shapes_ok, finite, n_files = True, True, {}
        for sub in ("gta_smoke", "attn_smoke"):
            found = sorted((tmp / "data" / sub).iterdir())
            n_files[sub] = len(found)
            for f in found:
                a = np.load(f)
                mel_len = np.load(tmp / "data" / "mel" / f.name).shape[1]
                finite &= bool(np.isfinite(a).all())
                if sub == "gta_smoke":
                    shapes_ok &= a.shape == (80, mel_len)
                else:   # (groups of its padded batch, its batch's T_text)
                    shapes_ok &= a.ndim == 2 and a.shape[0] * 5 > mel_len
        ok = (shapes_ok and finite
              and all(v == TT_ITEMS for v in n_files.values())
              and on_resident(export_launches, 2 * TT_ITEMS // 8, 0))
        emit("taco_train", stage="export", ok=ok, files=n_files,
             shapes_ok=shapes_ok, finite=finite, wall_s=export_s,
             launches=export_launches)
        if not ok:
            raise AssertionError("taco_train: GTA/attention export failed")

        # one full-width step, kernels against recurrence="scan", from the
        # same weights, batch and injected masks
        cfg_tt = Config(tts_train=TacotronTrainConfig(schedule=TT_SCHEDULE))
        batcher, _ = get_tts_datasets(tmp / "data", 32, 7, cfg_tt, seed=3)
        t0 = time.perf_counter()
        chars, mel_b, _, _ = next(iter(batcher))
        tt_collate_ms = (time.perf_counter() - t0) * 1e3
        xb = torch.from_numpy(chars).to(dev)
        mb = torch.from_numpy(mel_b).to(dev)
        G7 = mb.shape[-1] // 7
        state = tt.create_train_state(cfg.tts, 80, 1e-3, 1.0, seed=13,
                                      device=dev)
        masks = taco.draw_masks(state.model, xb.shape[0], xb.shape[1], G7,
                                torch.Generator(device=dev).manual_seed(5),
                                dev)
        # the same step with the plain loops in float64, the reference for
        # each float32 step, taking that step's branch at every ReLU,
        # max-pool and L1 term (``branch_grads``). Against one float64
        # step on its own branches, the few kinks that rounding turns
        # between the two moved gradients by up to 5e-2 (encoder leaves)
        # and the float32 orders by up to 2x each other; on the float32
        # step's branches the steps of five row orders lay within 5.1e-5 of
        # float64 (tools/probe_af_check.py). Each gradient of the kernel
        # step is held to its float64 step within max(1e-4, twice the
        # float32 scan step's largest distance in the same module), and the
        # loss within 1e-4 of the scan step's
        def tf_inputs(dt):
            return xb, mb.to(dt), {k: v.to(dt) for k, v in masks.items()}, None

        out = branch_steps(state.model, {"kernels": ("auto", tf_inputs),
                                         "scan": ("scan", tf_inputs)},
                           "teacher_forcing", 7)
        torch.cuda.synchronize()
        names = [n for n, _ in state.model.named_parameters()]
        cmp, ok = kernels_vs_scan(out, names)
        cmp = {"B": xb.shape[0], "T_text": xb.shape[1], "steps": mb.shape[-1],
               **cmp}
        emit("taco_train", stage="kernels_vs_scan", ok=ok, tolerance=B6_TOL,
             **cmp)
        if not ok:
            raise AssertionError("taco_train: the kernel step disagrees with "
                                 "the scan step")

        # speed: the trainer's loop and a resident batch, stage ms, a
        # profiled step
        gen_tt = torch.Generator(device=dev).manual_seed(6)

        def tstep(timings=None):
            return tt.train_step_tf(state, xb, mb, 7, generator=gen_tt,
                                    timings=timings)

        for _ in range(2):
            tstep()
        n_tt = 5
        stage_t = {}
        torch.cuda.synchronize()
        for _ in range(n_tt):
            tstep(stage_t)
        torch.cuda.synchronize()
        tt_stage_ms = {k: v / n_tt for k, v in elapsed_ms(stage_t).items()}
        t0 = time.perf_counter()
        for _ in range(n_tt):
            tstep()
        torch.cuda.synchronize()
        tt_resident_s = time.perf_counter() - t0
        dev_tt = step_kernels(tstep, ("taco_tf", "wgrad_gemm", "colsum",
                                      "reduce_parts"), top=12)
        dev_tt["b6_ms"] = dev_tt.pop("named_ms")
        dev_tt["b6_recurrence_ms"] = step_kernels(
            tstep, ("taco_tf",))["named_ms"]
        dev_tt["b5_ms"] = step_kernels(tstep, B5_KERNELS)["named_ms"]
        # B5 at the CBHG shapes: the encoder's BiGRU over T_text and the
        # postnet's over the frames, each direction a launch; the bound of
        # the four launches a direction
        g5 = cuda_gru.gru_seq_tm
        n5 = (g5.fwd_launches, g5.bwd_launches)
        tstep()
        cbhg = [(xb.shape[1], cfg.tts.encoder_dims)] * 2 + [
            (mb.shape[-1], cfg.tts.postnet_dims)] * 2
        dev_tt["b5_cbhg"] = {
            "launches": [g5.fwd_launches - n5[0], g5.bwd_launches - n5[1]],
            "fwd_ms": step_kernels(tstep, B5_KERNELS[::2])["named_ms"],
            "bwd_ms": step_kernels(tstep, B5_KERNELS[1::2])["named_ms"],
            "bound_ms": [sum(bound(*gru_work(Tq, xb.shape[0], H, 4, bw),
                                   PEAK_F32)[0] for Tq, H in cbhg)
                         for bw in (False, True)],
            "shapes_T_H": cbhg}
        dev_tt["idle_share"] = 1 - dev_tt["busy_ms"] / (
            1e3 * tt_resident_s / n_tt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = 0
        for cb, mbb, _, _ in prefetch(iter(lambda: next(iter(batcher)), None),
                                      device=dev):
            tt.train_step_tf(state, cb, mbb, 7, generator=gen_tt)
            done += 1
            if done == n_tt:
                break
        torch.cuda.synchronize()
        tt_loop_s = time.perf_counter() - t0
        emit("taco_train", stage="speed",
             steps_per_s=n_tt / tt_loop_s,
             steps_per_s_resident_batch=n_tt / tt_resident_s,
             step_ms=1e3 * tt_loop_s / n_tt, device=dev_tt,
             stage_ms={**tt_stage_ms, "data_collate_host": tt_collate_ms},
             batch=xb.shape[0], steps=mb.shape[-1], r=7)

        # ---- taco_af: attention forcing from the TF checkpoint ----
        from dataclasses import replace
        from wavernn_tpu_torch.cli.common import load_tts_model
        from wavernn_tpu_torch.timing import stage
        tf_ckpt = ckpt / "latest_weights.npz"
        teacher = load_tts_model(tf_ckpt, cfg, dev)[0]
        # the attention references at r 2, the teacher's eval TF forward
        t0 = time.perf_counter()
        zero_tf_counts(ct)
        ds2, _ = get_tts_datasets(tmp / "data", 8, 2, cfg_tt, seed=3)
        tt.create_attn_ref(teacher, ds2, 2, tmp / "data" / "attn_smoke_r2",
                           log=lambda *a: None)
        ref_launches = tf_counts(ct)
        found = sorted((tmp / "data" / "attn_smoke_r2").iterdir())
        finite = all(bool(np.isfinite(np.load(f)).all()) for f in found)
        ok = (len(found) == TT_ITEMS and finite
              and on_resident(ref_launches, TT_ITEMS // 8, 0))
        emit("taco_af", stage="attn_ref", ok=ok, files=len(found),
             finite=finite, launches=ref_launches,
             wall_s=time.perf_counter() - t0)
        if not ok:
            raise AssertionError("taco_af: the attention export failed")

        # the CLI in both AF modes, the lj_af_online_kl / lj_af_offline
        # settings with the depth cut to 3 steps
        n_af = AF_SCHEDULE[-1][2]
        af_launches = {}
        for tag, extra in (
                ("online", ("mode = 'attention_forcing_online'",
                            "attn_loss_coeff = 1.0",
                            f"model_tf_path = {str(tf_ckpt)!r}")),
                ("offline", ("mode = 'attention_forcing_offline'",
                             "attn_loss_coeff = 200.0",
                             "attn_ref_path = 'attn_smoke_r2'"))):
            hp_af = tmp / f"hparams_af_{tag}.py"
            hp_af.write_text("\n".join([
                f"data_path = {str(tmp / 'data')!r}",
                f"tts_model_id = 'smoke_af_{tag}'",
                f"tts_schedule = {AF_SCHEDULE!r}", "tts_checkpoint_every = 3",
                f"tts_init_weights_path = {str(tf_ckpt)!r}", *extra]) + "\n")
            ct.decoder_af.fwd_launches = ct.decoder_af.bwd_launches = 0
            zero_b5()
            for body in ("resident", "legacy"):
                for d_ in ("fwd", "bwd"):
                    setattr(ct.decoder_af, f"{body}_{d_}_launches", 0)
            zero_tf_counts(ct)
            t0 = time.perf_counter()
            cli(hp_file=hp_af)
            cli_s = time.perf_counter() - t0
            af = ct.decoder_af
            got = {"taco_af_fwd": af.fwd_launches,
                   "taco_af_bwd": af.bwd_launches,
                   "taco_af_res_fwd": af.resident_fwd_launches,
                   "taco_af_res_bwd": af.resident_bwd_launches,
                   "taco_af_legacy_fwd": af.legacy_fwd_launches,
                   "taco_af_legacy_bwd": af.legacy_bwd_launches,
                   **tf_counts(ct), **b5_counts()}
            af_launches[tag] = got
            online = tag == "online"
            # B7 1 + 1 a step; B5 4 + 4 for the student and, online, 2
            # forward for the teacher's encoder BiGRU; B6 forward once a
            # step for the online teacher (its postnet is skipped)
            # every B7 and B6 launch on its resident body, none on the
            # original
            want = {"taco_af_fwd": n_af, "taco_af_bwd": n_af,
                    "taco_af_res_fwd": n_af, "taco_af_res_bwd": n_af,
                    "taco_af_legacy_fwd": 0, "taco_af_legacy_bwd": 0,
                    "taco_tf_fwd": n_af if online else 0, "taco_tf_bwd": 0,
                    "taco_tf_res_fwd": n_af if online else 0,
                    "taco_tf_res_bwd": 0, "taco_tf_legacy_fwd": 0,
                    "taco_tf_legacy_bwd": 0,
                    "gru_res_fwd": (6 if online else 4) * n_af,
                    "gru_res_bwd": 4 * n_af, "gru_seq_fwd_legacy": 0,
                    "gru_seq_bwd_legacy": 0}
            ckpt_af = work / "checkpoints" / f"smoke_af_{tag}.tacotron"
            records = [json.loads(ln) for ln in
                       (ckpt_af / "metrics.jsonl").read_text().splitlines()]
            sessions = [r for r in records if r["event"] == "session"]
            files = {n: (ckpt_af / n).exists() for n in (
                "latest_weights.npz", "latest_optim.npz",
                "taco_step0K_weights.npz", "taco_step0K_optim.npz")}
            with np.load(ckpt_af / "latest_weights.npz") as z:
                meta = {"step": int(z["meta/step"]), "r": int(z["meta/r"])}
            res = {"sessions": [[r["r"], r["step"], r["loss"]]
                                for r in sessions],
                   "nonfinite_loss_steps": sum(r["nonfinite_loss_steps"]
                                               for r in sessions),
                   "nonfinite_grad_steps": sum(r["nonfinite_grad_steps"]
                                               for r in sessions),
                   "launches": got, "launches_expected": want,
                   "files": files, "meta": meta, "wall_s": cli_s}
            ok = (got == want and [r["step"] for r in sessions] == [n_af]
                  and all(math.isfinite(r["loss"]) for r in sessions)
                  and res["nonfinite_loss_steps"] == 0
                  and res["nonfinite_grad_steps"] == 0
                  and all(files.values()) and meta == {"step": n_af, "r": 2})
            emit("taco_af", stage=f"cli_{tag}", ok=ok, **res)
            if not ok:
                raise AssertionError(f"taco_af: the AF-{tag} CLI run failed "
                                     "a check")

        # one full-width AF-offline step, kernels against recurrence="scan",
        # from the TF checkpoint's weights, one batch cut to AF_FRAMES
        # frames, the same injected masks
        cfg_off = Config(tts=replace(cfg.tts,
                                     mode="attention_forcing_offline"),
                         tts_train=TacotronTrainConfig(
                             schedule=AF_SCHEDULE,
                             attn_ref_path="attn_smoke_r2"))
        batcher_af, _ = get_tts_datasets(tmp / "data", 32, 2, cfg_off, seed=3)
        t0 = time.perf_counter()
        chars, mel_b, _, _, aref_b = next(iter(batcher_af))
        af_collate_ms = (time.perf_counter() - t0) * 1e3
        steps_af = min(mel_b.shape[-1], AF_FRAMES)
        xa = torch.from_numpy(chars).to(dev)
        ma = torch.from_numpy(mel_b[:, :, :steps_af]).to(dev)
        Ga = steps_af // 2
        aa = torch.from_numpy(aref_b[:, :Ga]).to(dev)
        state_af = tt.create_train_state(cfg.tts, 80, 1e-3, 1.0, seed=13,
                                         device=dev)
        state_af.model.load_state_dict(teacher.state_dict())
        masks_af = taco.draw_masks(state_af.model, xa.shape[0], xa.shape[1],
                                   Ga, torch.Generator(device=dev)
                                   .manual_seed(8), dev)
        # The AF recurrence feeds each group's mel back through the prenet,
        # so float32 rounding grows along 200 groups: on the H100 the
        # float32 plain step lay up to 2.1e-3 from float64 on decoder
        # leaves, and by 2x more or less in another summation order
        # (tools/probe_af_scatter.py, random weights). One float32 sample
        # is no floor, so the plain step runs twice, the second time on the
        # batch with its rows reversed (the gradients are sums over rows).
        # Each float32 step is held to a float64 step on its own branches
        # (``branch_grads``): against one float64 step, the 9 to 21 kinks
        # whose branch rounding turns made a postnet leaf's distance jump
        # between 5e-3 and 1.6e-2 from one row order to another, and the
        # rule failed on 6 of 30 plain-against-plain trials; on each step's
        # branches every distance was below 1.5e-5 and no trial failed
        # (tools/probe_af_check.py, random weights)
        rev = torch.arange(xa.shape[0] - 1, -1, -1, device=dev)

        def rows(k, v, reverse):
            if not reverse:
                return v
            return v[:, rev] if k[:3] in ("dec", "zm1", "zm2") else v[rev]

        def af_inputs(reverse):
            return lambda dt: (
                rows("x", xa, reverse), rows("m", ma, reverse).to(dt),
                {k: rows(k, v, reverse).to(dt) for k, v in masks_af.items()},
                rows("a", aa, reverse).to(dt))

        out = branch_steps(state_af.model,
                           {"kernels": ("auto", af_inputs(False)),
                            "scan": ("scan", af_inputs(False)),
                            "scan_rev": ("scan", af_inputs(True))},
                           "attention_forcing_offline", 2, coeff=200.0)
        torch.cuda.synchronize()
        names = [n for n, _ in state_af.model.named_parameters()]
        cmp, ok = kernels_vs_scan(out, names)
        emit("taco_af", stage="kernels_vs_scan", ok=ok, tolerance=B6_TOL,
             B=xa.shape[0], T_text=xa.shape[1], steps=steps_af, **cmp)
        if not ok:
            raise AssertionError("taco_af: the kernel step disagrees with "
                                 "the scan step")

        # speed of both steps on that resident batch, a profiled step of
        # each, and AF-offline through the trainer's loop
        gen_af = torch.Generator(device=dev).manual_seed(9)

        def af_step(online, timings=None):
            if online:
                with stage(timings, "teacher", dev):
                    ref = tt.teacher_attn_ref(teacher, xa, ma, 2)
                return tt.train_step_af(state_af, xa, ma, ref, 2, 1.0, False,
                                        generator=gen_af, timings=timings)
            return tt.train_step_af(state_af, xa, ma, aa, 2, 200.0, True,
                                    generator=gen_af, timings=timings)

        af_speed = {}
        for online in (False, True):
            fn = lambda timings=None: af_step(online, timings)
            for _ in range(2):
                fn()
            stage_t = {}
            torch.cuda.synchronize()
            for _ in range(n_tt):
                fn(stage_t)
            torch.cuda.synchronize()
            st_ms = {k: v / n_tt for k, v in elapsed_ms(stage_t).items()}
            t0 = time.perf_counter()
            for _ in range(n_tt):
                fn()
            torch.cuda.synchronize()
            res_s = time.perf_counter() - t0
            dv = step_kernels(fn, ("taco_af", "wgrad_gemm", "colsum",
                                   "reduce_parts"), top=12)
            dv["b7_ms"] = dv.pop("named_ms")
            dv["b7_recurrence_ms"] = step_kernels(fn, ("taco_af",))[
                "named_ms"]
            dv["b6_ms"] = step_kernels(fn, ("taco_tf",))["named_ms"]
            dv["b5_ms"] = step_kernels(fn, B5_KERNELS)["named_ms"]
            dv["b7_share"] = dv["b7_ms"] / dv["busy_ms"]
            dv["idle_share"] = 1 - dv["busy_ms"] / (1e3 * res_s / n_tt)
            af_speed["online" if online else "offline"] = {
                "steps_per_s_resident_batch": n_tt / res_s,
                "stage_ms": st_ms, "device": dv}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = 0
        for cb, mbb, _, _, ab in prefetch(
                iter(lambda: next(iter(batcher_af)), None), device=dev):
            tt.train_step_af(state_af, cb, mbb, ab, 2, 200.0, True,
                             generator=gen_af)
            done += 1
            if done == n_tt:
                break
        torch.cuda.synchronize()
        af_loop_s = time.perf_counter() - t0
        # B7's two bodies in turns at this batch's shape (seeded inputs)
        ins_a, w_a = b7_case(xa.shape[0], xa.shape[1], Ga, 2, dev, 56, True)
        with torch.no_grad():
            _, sc_a, st_a = ct.decoder_af_fwd(*ins_a, w_a, save=True)
            dm_a = torch.randn(Ga, xa.shape[0], 160, device=dev)
            ds_a = torch.randn_like(sc_a)
            af_turns = {
                "fwd": turns(lambda: ct.decoder_af_fwd(*ins_a, w_a, save=True),
                             lambda: ct.decoder_af_fwd(*ins_a, w_a, save=True,
                                                       _legacy=True), 3),
                "bwd": turns(lambda: ct.decoder_af_bwd(dm_a, ds_a, st_a, sc_a,
                                                       *ins_a, w_a),
                             lambda: ct.decoder_af_bwd(dm_a, ds_a, st_a, sc_a,
                                                       *ins_a, w_a,
                                                       _legacy=True), 3)}
        emit("taco_af", stage="speed", **af_speed, b7_turns=af_turns,
             steps_per_s_offline_loop=n_tt / af_loop_s,
             step_ms_offline_loop=1e3 * af_loop_s / n_tt,
             data_collate_host_ms=af_collate_ms, batch=xa.shape[0],
             steps=steps_af, T_text=xa.shape[1], r=2)

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
        # the SM clock and its limit reasons around every timed kernel set
        clocks = {"b1": [gpu_clocks()]}
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
        clocks["b1"].append(gpu_clocks())
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
        clocks["b2"] = [gpu_clocks()]
        b2_ms, got = cuda_ms(lambda: cuda_taco.decode(*dargs), 10)
        clocks["b2"].append(gpu_clocks())
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
        zero_b5()
        clocks["b5"] = [gpu_clocks()]
        f_ms, (ys, sv) = cuda_ms(lambda: cuda_gru.gru_seq_fwd(gi, wh, bh, h0),
                                 5)
        bw_ms, _ = cuda_ms(lambda: cuda_gru.gru_seq_bwd(sv, ys, wh, h0, dys), 5)
        clocks["b5"].append(gpu_clocks())
        f_plain, _ = cuda_ms(lambda: cuda_gru.gru_seq_ref(gi, wh, bh, h0), 1)
        bw_plain, _ = cuda_ms(lambda: cuda_gru.gru_seq_bwd_ref(
            sv, ys, wh, h0, dys), 1)
        b5_main, ok5 = check_b5(cuda_gru, gi, wh, bh, h0, dys)
        # every launch of these timings on the resident body (6 + 6 timed,
        # 1 + 1 checked)
        b5_main["launches"] = b5_counts()
        ok5 = ok5 and b5_on_resident(b5_main["launches"], 7, 7)
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
    # B6 at the b6 phase's full-width shape, kernel and plain version on
    # the same inputs (the backward on the kernel forward's streams)
    ins6, w6 = b6_case(*B6_FULL, dev, 31, True)
    with torch.no_grad():
        clocks["b6"] = [gpu_clocks()]
        f6_ms, (mel6, sc6, st6) = cuda_ms(
            lambda: ct.decoder_tf_fwd(*ins6, w6, save=True), 3)
        g6 = torch.Generator().manual_seed(32)
        dmel6 = torch.randn(mel6.shape, generator=g6).to(dev)
        dsc6 = torch.randn(sc6.shape, generator=g6).to(dev)
        b6_ms, _ = cuda_ms(lambda: ct.decoder_tf_bwd(
            dmel6, dsc6, st6, sc6, *ins6, w6), 3)
        clocks["b6"].append(gpu_clocks())
        f6_plain, _ = cuda_ms(lambda: ct.core_ref(*ins6, *w6, save=True), 1)
        b6_plain, _ = cuda_ms(lambda: ct.core_bwd_ref(
            dmel6, dsc6, st6, sc6, *ins6, *w6), 1)
        b6_main, ok6 = check_b6(ct, ins6, w6, 33)
    Bq, Tq, Gq, rq = B6_FULL
    dims6 = (Gq, Bq, Tq, 256, 256, 128, 512, rq * 80)
    fl6f, by6f = b6_work(*dims6, False)
    fl6b, by6b = b6_work(*dims6, True)
    b6f_bound, b6f_by = bound(fl6f, by6f, PEAK_F32)
    b6b_bound, b6b_by = bound(fl6b, by6b, PEAK_F32)
    # B7 at the b7 phase's full-width shape, likewise
    ins7, w7 = b7_case(*B7_FULL, dev, 34, True)
    with torch.no_grad():
        clocks["b7"] = [gpu_clocks()]
        f7_ms, (mel7, sc7, st7) = cuda_ms(
            lambda: ct.decoder_af_fwd(*ins7, w7, save=True), 3)
        g7 = torch.Generator().manual_seed(35)
        dmel7 = torch.randn(mel7.shape, generator=g7).to(dev)
        dsc7 = torch.randn(sc7.shape, generator=g7).to(dev)
        b7_ms, _ = cuda_ms(lambda: ct.decoder_af_bwd(
            dmel7, dsc7, st7, sc7, *ins7, w7), 3)
        clocks["b7"].append(gpu_clocks())
        f7_plain, _ = cuda_ms(lambda: ct.core_af_ref(*ins7, *w7, save=True),
                              1)
        b7_plain, _ = cuda_ms(lambda: ct.core_af_bwd_ref(
            dmel7, dsc7, st7, sc7, *ins7, *w7), 1)
        b7_main, ok7 = check_b7(ct, ins7, w7, 36)
    B7b, T7, G7, r7 = B7_FULL
    dims7 = (G7, B7b, T7, 256, 256, 256, 128, 512, r7 * 80, 80)
    fl7f, by7f = b7_work(*dims7, False)
    fl7b, by7b = b7_work(*dims7, True)
    b7f_bound, b7f_by = bound(fl7f, by7f, PEAK_F32)
    b7b_bound, b7b_by = bound(fl7b, by7b, PEAK_F32)
    # B6's launches on the TF paths (the CLI's steps, the exports, the
    # attention references and the online teacher): on each body
    tf_paths = {k: tt_launches[k] + export_launches[k] + ref_launches[k]
                + af_launches["online"][k] for k in tf_counts(ct)}
    # B7's launches on the AF paths: the resident body's, the original's
    af_total = {k: sum(v[f"taco_af_res_{k[-3:]}"] for v in af_launches.values())
                for k in ("taco_af_fwd", "taco_af_bwd")}
    af_legacy = {k: sum(v[k] for v in af_launches.values())
                 for k in ("taco_af_legacy_fwd", "taco_af_legacy_bwd")}
    # B3 at the b1 shape (the main mel upsampled and folded: 10 folds x
    # 12,100 steps) and unbatched (1 x 12,100), bfloat16 matrices and
    # counter-hash noise as the serving paths call it; B8 at B 5 and 32
    from wavernn_tpu_torch.ops.fold import fold_with_overlap
    with torch.no_grad():
        mu, au = voc.upsample(torch.nn.functional.pad(mels, (2, 2)))
        muf = fold_with_overlap(mu, cfg.voc.target, cfg.voc.overlap)
        auf = fold_with_overlap(au, cfg.voc.target, cfg.voc.overlap)
        b3_t = {}
        for tag, (m3, a3) in (("folds", (muf, auf)),
                              ("unbatched", (mu[:, :T].contiguous(),
                                             au[:, :T].contiguous()))):
            clk = [gpu_clocks()]
            k_ms, (g3, _) = cuda_ms(lambda: cuda_gen.generate_materialized(
                core, m3, a3, cfg.voc.mode, seed=7), 2)
            clk.append(gpu_clocks())
            p_ms, (p3, _) = cuda_ms(
                lambda: cuda_gen.generate_materialized_ref(
                    core16, m3, a3, cfg.voc.mode, seed=7), 1)
            chk, ok_t = check_b1_bf16(g3, p3)
            fl3, by3 = b3_work(m3.shape[0], m3.shape[1], R, FC,
                               cfg.voc.aux_dims, 80, 30, 2)
            b_ms, b_by = bound(fl3, by3, PEAK_BF16)
            b3_t[tag] = {"B": m3.shape[0], "steps": m3.shape[1], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "flops": fl3, "bytes": by3,
                         "us_per_step": 1e3 * k_ms / m3.shape[1],
                         "clocks": clk, "check": chk, "ok": ok_t}
        b8_t = {}
        for B8 in (5, 32):
            args8, lens8, _ = b8_cases[B8]
            clk = [gpu_clocks()]
            k_ms, got8 = cuda_ms(lambda: cuda_taco.decode_batch(*args8, -1e30),
                                 3)
            clk.append(gpu_clocks())
            p_ms, want8 = cuda_ms(
                lambda: cuda_taco.decode_batch_ref(*args8, -1e30), 1)
            chk, ok_t = check_b8(got8, want8, MEL_TOL, ATT_TOL)
            G8 = 200
            fl8, by8 = b8_work([min(n + 1, G8) for n in got8[2].tolist()],
                               lens8, args8[1].shape[1], 256, 256, 256, 128,
                               512, 2 * 80, 80, G8)
            b_ms, b_by = bound(fl8, by8, PEAK_F32)
            b8_t[B8] = {"T_text": args8[1].shape[1], "groups": G8, "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "flops": fl8, "bytes": by8,
                       "us_per_group": 1e3 * k_ms / G8, "clocks": clk,
                       "check": {k: v for k, v in chk.items()
                                 if k != "n_valid"}, "ok": ok_t}
    ok3 = all(v["ok"] for v in b3_t.values())
    ok8 = all(v["ok"] for v in b8_t.values())
    ok = ok16 and ok32 and ok2 and ok5 and ok6 and ok7 and ok3 and ok8
    emit("timings", ok=ok, b3=b3_t, b8=b8_t, clocks=clocks,
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
             "check": b5_main},
         b6={"B": Bq, "T_text": Tq, "G": Gq, "r": rq, "fwd_ms": f6_ms,
             "bwd_ms": b6_ms, "fwd_plain_ms": f6_plain,
             "bwd_plain_ms": b6_plain, "fwd_bound_ms": b6f_bound,
             "bwd_bound_ms": b6b_bound, "fwd_flops": fl6f,
             "fwd_bytes": by6f, "bwd_flops": fl6b, "bwd_bytes": by6b,
             "us_per_group": [1e3 * f6_ms / Gq, 1e3 * b6_ms / Gq],
             "launches_per_train_step": [
                 tt_launches["taco_tf_res_fwd"] / TT_SCHEDULE[-1][2],
                 tt_launches["taco_tf_res_bwd"] / TT_SCHEDULE[-1][2]],
             "check": {k: v for k, v in b6_main.items()
                       if k != "grad_rel_err"}},
         b7={"B": B7b, "T_text": T7, "G": G7, "r": r7, "fwd_ms": f7_ms,
             "bwd_ms": b7_ms, "fwd_plain_ms": f7_plain,
             "bwd_plain_ms": b7_plain, "fwd_bound_ms": b7f_bound,
             "bwd_bound_ms": b7b_bound, "fwd_flops": fl7f,
             "fwd_bytes": by7f, "bwd_flops": fl7b, "bwd_bytes": by7b,
             "us_per_group": [1e3 * f7_ms / G7, 1e3 * b7_ms / G7],
             "launches_per_train_step": [af_total["taco_af_fwd"] / (2 * n_af),
                                         af_total["taco_af_bwd"] / (2 * n_af)],
             "check": {k: v for k, v in b7_main.items()
                       if k != "grad_rel_err"}})
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the main path's shapes")

    # ---- resident: the redesigned body against the original body ----
    resident = phase_resident(cfg, dev, voc, mel,
                              logs.get("sample_loop_resident", ""), TOL)
    # ---- sparse: B9 at the b1 shape, one row and one streaming block ----
    sparse = phase_sparse(cfg, dev, voc, mel, TOL)
    # ---- seam: B4b and exact-seam generation; b10: the pre-projected
    # loop, each with its timings ----
    seam = phase_seam(cfg, dev, voc, mel, TOL)
    b10 = phase_b10(cfg, dev, voc, mel, TOL)

    # ---- mesh: the multi-device paths, one NCCL rank a card and two
    # ranks sharing card 0 over gloo ----
    phase_mesh(cfg, dev, voc, tts, mel, smi)

    # ---- a12: wav -> dataset -> trained vocoder, .wav -> vocoded .wav,
    # text -> Griffin-Lim wav with its attention png, on the card ----
    phase_a12(cfg, dev, tts)

    # B1, B3 and B4b run on the resident body; their original body's entries
    # keep its times from the resident phase's turns, its errors against
    # the plain versions there, and its launches on the paths: none
    rt, old_err = resident["timing"], resident["old_body_max_abs_err"]
    b1_err = max(b1["MOL"]["f32_injected_max_abs_err"],
                 b1["MOL"]["prng_max_abs_err"], b1_main["f32_max_abs_err"])
    b1_by = "operations" if fl / PEAK_BF16 >= by / PEAK_BYTES else "bytes"
    b3_err = max(b3["f32_odd_max_abs_err"], b3["f32_odd_state_max_abs_err"])
    unb = serve_counts["tts_to_wav_unbatched"]
    b2_by = "operations" if fl2 / PEAK_F32 >= by2 / PEAK_BYTES else "bytes"

    def b8res_errs(prefix, side, rows=False):
        """b8res's mel errors of one side over its shapes: those of one row
        (prefix B1), or with rows=True those of a batch."""
        return [v[side]["mel_max_abs_err"]
                for name, sh in b8res["shapes"].items()
                if (sh["B"] > 1) == rows and name.startswith(prefix)
                for v in [sh[c] for c in ("no_stop", "forced_stop")
                          if c in sh] + [sh] if side in v]
    seam_l = seam["path"]["seam"]["launches"]
    kernels = [
        {"name": "sample_loop_resident", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:673",
         "launches": launches["sample_loop_resident"],
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain,
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None},
        {"name": "sample_loop_resident_mat", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:220",
         "launches": unb["sample_loop_resident_mat"] + stream_b3,
         "max_abs_err": b3_err, "ms": b3_t["folds"]["ms"],
         "plain_ms": b3_t["folds"]["plain_ms"],
         "bound_ms": b3_t["folds"]["bound_ms"],
         "bound_by": b3_t["folds"]["bound_by"], "library_ms": None},
        {"name": "sample_loop_resident_state", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:673",
         "launches": seam_l["sample_loop_resident_state"],
         "max_abs_err": seam["max_abs_err"], "ms": seam["timing"]["ms"],
         "plain_ms": seam["timing"]["plain_ms"],
         "bound_ms": seam["timing"]["bound_ms"],
         "bound_by": seam["timing"]["bound_by"], "library_ms": None},
        {"name": "sample_loop_fused", "route": "cuda", "source": B1_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gen.py:673",
         "launches": counts["sample_loop_old_dense"],
         "max_abs_err": old_err["b1"], "ms": min(rt["b1_main_ms"]["old"]),
         "plain_ms": b1_plain, "bound_ms": b1_bound, "bound_by": b1_by,
         "library_ms": None},
        {"name": "taco_decode", "route": "cuda", "source": B2RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco.py:74",
         "launches": launches["taco_decode"],
         "max_abs_err": max([b2["no_stop"]["mel_max_abs_err"],
                             b2["forced_stop"]["mel_max_abs_err"],
                             b2_main["mel_max_abs_err"]]
                            + b8res_errs("B1", "new_vs_plain")),
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
        {"name": "taco_decode_legacy", "route": "cuda", "source": B2_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco.py:74",
         "launches": counts["taco_decode_legacy"]
         + sum(c["taco_decode_legacy"] for c in serve_counts.values()),
         "max_abs_err": max(b8res_errs("B1", "old_vs_plain")),
         "ms": min(b8res["turns"]["B1_T42"]["old"]), "plain_ms": b2_plain,
         "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None},
        {"name": "sample_loop_materialized", "route": "cuda",
         "source": B1_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:220",
         "launches": unb["sample_loop_old_dense"],
         "max_abs_err": old_err["b3"], "ms": min(rt["b3_folds_ms"]["old"]),
         "plain_ms": b3_t["folds"]["plain_ms"],
         "bound_ms": b3_t["folds"]["bound_ms"],
         "bound_by": b3_t["folds"]["bound_by"], "library_ms": None},
        {"name": "taco_decode_batch", "route": "cuda", "source": B2RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco.py:207",
         "launches": sum(c["taco_decode_batch"]
                         for c in serve_counts.values()),
         "max_abs_err": max([v["mel_max_abs_err"] for v in b8.values()]
                            + b8res_errs("B", "new_vs_plain", rows=True)),
         "ms": b8_t[5]["ms"], "plain_ms": b8_t[5]["plain_ms"],
         "bound_ms": b8_t[5]["bound_ms"], "bound_by": b8_t[5]["bound_by"],
         "library_ms": None},
        {"name": "taco_decode_batch_legacy", "route": "cuda",
         "source": B2_SOURCE, "replaces": "wavernn_tpu/ops/pallas_taco.py:207",
         "launches": sum(c["taco_decode_batch_legacy"]
                         for c in serve_counts.values()),
         "max_abs_err": max(b8res_errs("B", "old_vs_plain", rows=True)),
         "ms": min(b8res["turns"]["B5_T43"]["old"]),
         "plain_ms": b8_t[5]["plain_ms"], "bound_ms": b8_t[5]["bound_ms"],
         "bound_by": b8_t[5]["bound_by"], "library_ms": None},
        {"name": "gru_res_fwd", "route": "cuda", "source": B5RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:57",
         "launches": b5_launches["gru_res_fwd"],
         "max_abs_err": max([b5_main["ys_max_abs_err"]]
                            + [r["ys_max_abs_err"] for k, r in b5.items()
                               if k.endswith("f32")]
                            + [r["new_vs_plain"]["ys_max_abs_err"]
                               for r in b5res["shapes"].values()
                               if r["dtype"] == "float32"]),
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": b5f_bound,
         "bound_by": b5f_by, "library_ms": lib_fwd_ms},
        {"name": "gru_res_bwd", "route": "cuda", "source": B5RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:122",
         "launches": b5_launches["gru_res_bwd"],
         "max_abs_err": max([b5_main["bwd_max_abs_err"]]
                            + [r["bwd_max_abs_err"] for k, r in b5.items()
                               if k.endswith("f32")]
                            + [r["new_vs_plain"]["bwd_max_abs_err"]
                               for r in b5res["shapes"].values()
                               if r["dtype"] == "float32"]),
         "ms": bw_ms, "plain_ms": bw_plain, "bound_ms": b5b_bound,
         "bound_by": b5b_by, "library_ms": lib_bwd_ms},
        {"name": "gru_seq_fwd", "route": "cuda", "source": B5_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:57",
         "launches": b5_launches["gru_seq_fwd_legacy"],
         "max_abs_err": max(r["legacy_vs_plain"]["ys_max_abs_err"]
                            for r in b5res["shapes"].values()
                            if r["dtype"] == "float32"),
         "ms": min(b5res["turns"]["voc"]["fwd"]["old"]), "plain_ms": f_plain,
         "bound_ms": b5f_bound, "bound_by": b5f_by,
         "library_ms": lib_fwd_ms},
        {"name": "gru_seq_bwd", "route": "cuda", "source": B5_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gru.py:122",
         "launches": b5_launches["gru_seq_bwd_legacy"],
         "max_abs_err": max(r["legacy_vs_plain"]["bwd_max_abs_err"]
                            for r in b5res["shapes"].values()
                            if r["dtype"] == "float32"),
         "ms": min(b5res["turns"]["voc"]["bwd"]["old"]), "plain_ms": bw_plain,
         "bound_ms": b5b_bound, "bound_by": b5b_by,
         "library_ms": lib_bwd_ms},
        {"name": "taco_tf_res_fwd", "route": "cuda", "source": B6RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:80",
         "launches": tf_paths["taco_tf_res_fwd"],
         "max_abs_err": max([b6_main["fwd_max_abs_err"]]
                            + [r["fwd_max_abs_err"] for r in b6.values()]
                            + [r["fwd_max_abs_err"]
                               for r in b6res["shapes"].values()]),
         "ms": f6_ms, "plain_ms": f6_plain, "bound_ms": b6f_bound,
         "bound_by": b6f_by, "library_ms": None},
        {"name": "taco_tf_res_bwd", "route": "cuda", "source": B6RES_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:350",
         "launches": tf_paths["taco_tf_res_bwd"],
         "max_abs_err": max([b6_main["bwd_max_abs_err"]]
                            + [r["bwd_max_abs_err"] for r in
                               list(b6.values())
                               + list(b6res["shapes"].values())
                               if "bwd_max_abs_err" in r]),
         "ms": b6_ms, "plain_ms": b6_plain, "bound_ms": b6b_bound,
         "bound_by": b6b_by, "library_ms": None},
        {"name": "taco_tf_fwd_legacy", "route": "cuda", "source": B6_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:80",
         "launches": tf_paths["taco_tf_legacy_fwd"],
         "max_abs_err": b6res["legacy_vs_plain"]["fwd_max_abs_err"],
         "ms": min(b6res["turns"]["fwd"]["old"]), "plain_ms": f6_plain,
         "bound_ms": b6f_bound, "bound_by": b6f_by, "library_ms": None},
        {"name": "taco_tf_bwd_legacy", "route": "cuda", "source": B6_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:350",
         "launches": tf_paths["taco_tf_legacy_bwd"],
         "max_abs_err": b6res["legacy_vs_plain"]["bwd_max_abs_err"],
         "ms": min(b6res["turns"]["bwd"]["old"]), "plain_ms": b6_plain,
         "bound_ms": b6b_bound, "bound_by": b6b_by, "library_ms": None},
        {"name": "taco_af_fwd", "route": "cuda", "source": B7_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:802",
         "launches": af_total["taco_af_fwd"],
         "max_abs_err": max([b7_main["fwd_max_abs_err"]]
                            + [r["fwd_max_abs_err"] for r in b7.values()]),
         "ms": f7_ms, "plain_ms": f7_plain, "bound_ms": b7f_bound,
         "bound_by": b7f_by, "library_ms": None},
        {"name": "taco_af_bwd", "route": "cuda", "source": B7_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:925",
         "launches": af_total["taco_af_bwd"],
         "max_abs_err": max([b7_main["bwd_max_abs_err"]]
                            + [r["bwd_max_abs_err"] for r in b7.values()
                               if "bwd_max_abs_err" in r]),
         "ms": b7_ms, "plain_ms": b7_plain, "bound_ms": b7b_bound,
         "bound_by": b7b_by, "library_ms": None},
        {"name": "taco_af_fwd_legacy", "route": "cuda", "source": B6_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:802",
         "launches": af_legacy["taco_af_legacy_fwd"],
         "max_abs_err": b7res["legacy_vs_plain"]["fwd_max_abs_err"],
         "ms": min(b7res["turns"]["fwd"]["old"]), "plain_ms": f7_plain,
         "bound_ms": b7f_bound, "bound_by": b7f_by, "library_ms": None},
        {"name": "taco_af_bwd_legacy", "route": "cuda", "source": B6_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_taco_train.py:925",
         "launches": af_legacy["taco_af_legacy_bwd"],
         "max_abs_err": b7res["legacy_vs_plain"]["bwd_max_abs_err"],
         "ms": min(b7res["turns"]["bwd"]["old"]), "plain_ms": b7_plain,
         "bound_ms": b7b_bound, "bound_by": b7b_by, "library_ms": None},
        {"name": "sample_loop_resident_sparse", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:119",
         "launches": prune["serve_launches"]["sample_loop_resident_sparse"],
         "max_abs_err": sparse["f32_max_abs_err"], "ms": sparse["ms"],
         "plain_ms": sparse["plain_ms"], "bound_ms": sparse["bound_ms"],
         "bound_by": sparse["bound_by"], "library_ms": None},
        {"name": "sample_loop_resident_mat_sparse", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen.py:119",
         "launches": sparse["stream_launches"]
         ["sample_loop_resident_mat_sparse"],
         "max_abs_err": sparse["b3_1row_f32_max_abs_err"],
         "ms": min(sparse["b3_block_turns_ms"]["new"]),
         "plain_ms": sparse["b3_block_plain_ms"],
         "bound_ms": sparse["b3_block_bound_ms"],
         "bound_by": sparse["b3_block_bound_by"], "library_ms": None},
        {"name": "sample_loop_sparse", "route": "cuda", "source": B1_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gen.py:119",
         "launches": prune["serve_launches"]["sample_loop_sparse"],
         "max_abs_err": sparse["f32_max_abs_err"],
         "ms": sparse["legacy_ms"], "plain_ms": sparse["plain_ms"],
         "bound_ms": sparse["bound_ms"], "bound_by": sparse["bound_by"],
         "library_ms": None},
        {"name": "sample_loop_fused_state", "route": "cuda",
         "source": B1_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gen.py:673",
         "launches": seam_l["sample_loop_old_dense"],
         "max_abs_err": old_err["b4b"],
         "ms": min(rt["b4b_main_ms"]["old"]),
         "plain_ms": seam["timing"]["plain_ms"],
         "bound_ms": seam["timing"]["bound_ms"],
         "bound_by": seam["timing"]["bound_by"], "library_ms": None},
        {"name": "sample_loop_resident_v2", "route": "cuda",
         "source": RES_SOURCE, "replaces": "wavernn_tpu/ops/pallas_gen2.py:59",
         "launches": b10["path"]["launches"]["sample_loop_resident_v2"],
         "max_abs_err": b10["max_abs_err"],
         "ms": b10["timing"]["folds"]["ms"],
         "plain_ms": b10["timing"]["folds"]["plain_ms"],
         "bound_ms": b10["timing"]["folds"]["bound_ms"],
         "bound_by": b10["timing"]["folds"]["bound_by"], "library_ms": None},
        {"name": "sample_loop_v2", "route": "cuda", "source": B1_SOURCE,
         "replaces": "wavernn_tpu/ops/pallas_gen2.py:59",
         "launches": b10["path"]["launches"]["sample_loop_v2"],
         "max_abs_err": b10["max_abs_err"],
         "ms": b10["timing"]["folds"]["legacy_ms"],
         "plain_ms": b10["timing"]["folds"]["plain_ms"],
         "bound_ms": b10["timing"]["folds"]["bound_ms"],
         "bound_by": b10["timing"]["folds"]["bound_by"], "library_ms": None},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
