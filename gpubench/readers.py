"""The reductions the per-layer metric files (``metrics/<name>.py``) share.
Each takes the harness's ``LayerContext`` and returns a number, or None
where the run gave it nothing to read (no trace, no such kernel)."""
from __future__ import annotations

from . import yardstick as Y


def _stage_ms(ctx, stages):
    if not ctx.stage_ms or not ctx.calls:
        return None
    return sum(ctx.stage_ms.get(s, 0.0) for s in stages) / len(ctx.calls)


def taco_ms(ctx):
    """Device ms a call of the Tacotron's three stages (encoder, decode,
    postnet), from the program's CUDA events."""
    return _stage_ms(ctx, ("encoder", "decode_kernel", "postnet"))


def voc_side_ms(ctx):
    """Device ms a call of the vocoder's work outside the sample loop
    (conditioning, crossfade)."""
    return _stage_ms(ctx, ("vocoder_conditioning", "crossfade"))


def idle_pct(ctx):
    """The share of the window in which no operation ran on the device."""
    if ctx.busy_s is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def _share(least_s, kernel_s):
    return 100.0 * least_s / kernel_s if kernel_s > 0 else None


def b1_roofline(ctx):
    """B1's least time over the window's calls, over its device time."""
    d, c = Y.dims(ctx.cfg), ctx.cfg
    least = sum(Y.least_s(*Y.b1_call(d, call["folds"], c["voc_target"],
                                     c["voc_overlap"]), Y.PEAK_BF16)
                for call in ctx.calls)
    return _share(least, ctx.kernel_s("sample_loop_resident"))


def serve_mfu(ctx):
    """The window's share of the card's peak: the model FLOPs of every
    completed call (Tacotron and MelResNet at the float32 peak, the sample
    loop's products at the bfloat16 peak) as least time, over the
    window."""
    if ctx.busy_s is None:
        return None
    d, c = Y.dims(ctx.cfg), ctx.cfg
    t = 0.0
    for call in ctx.calls:
        f32 = sum(Y.tacotron_flops(d, 1, u["T_text"], u["frames"], c["tts_r"])
                  + Y.melresnet_flops(d, u["frames"]) for u in call["utts"])
        t += f32 / Y.PEAK_F32
        t += Y.b1_call(d, call["folds"], c["voc_target"],
                       c["voc_overlap"])[0] / Y.PEAK_BF16
    return 100.0 * t / ctx.window_s


def b7_roofline(ctx):
    """B7's least time, forward and backward, over its device time: both
    resident bodies and the backward's weight-gradient reductions
    (``wgrad_gemm``, ``colsum``, ``reduce_parts``), which no other kernel
    of the training step launches."""
    d = Y.dims(ctx.cfg)
    least = 0.0
    for s in ctx.calls:
        for fl, nb in Y.b7_step(d, s["B"], s["T_text"], s["frames"], s["r"]):
            least += Y.least_s(fl, nb, Y.PEAK_F32)
    return _share(least, ctx.kernel_s("taco_af_res_fwd", "taco_af_res_bwd",
                                      "wgrad_gemm", "colsum", "reduce_parts"))


def b5_roofline(ctx):
    """B5's least time at the CBHG BiGRUs' shapes over its device time."""
    d = Y.dims(ctx.cfg)
    least = sum(Y.least_s(fl, nb, Y.PEAK_F32) for s in ctx.calls
                for fl, nb in Y.b5_cbhg_step(d, s["B"], s["T_text"],
                                             s["frames"]))
    return _share(least, ctx.kernel_s("gru_res_fwd", "gru_res_bwd"))


def train_mfu(ctx):
    """The window's share of the float32 peak: three times the forward
    FLOPs of every step (forward and backward) as least time, over the
    window."""
    if ctx.busy_s is None:
        return None
    d = Y.dims(ctx.cfg)
    t = sum(3 * Y.tacotron_flops(d, s["B"], s["T_text"], s["frames"], s["r"])
            for s in ctx.calls) / Y.PEAK_F32
    return 100.0 * t / ctx.window_s


def b5_voc_roofline(ctx):
    """B5's least time at the vocoder's two GRUs, forward and backward,
    over its device time."""
    d = Y.dims(ctx.cfg)
    least = sum(Y.least_s(fl, nb, Y.PEAK_F32) for s in ctx.calls
                for fl, nb in Y.b5_voc_step(d, s["B"], s["T"]))
    return _share(least, ctx.kernel_s("gru_res_fwd", "gru_res_bwd"))


def voc_train_mfu(ctx):
    """A vocoder-training window's share of the float32 peak: three times
    the forward FLOPs of every step as least time, over the window."""
    if ctx.busy_s is None:
        return None
    d = Y.dims(ctx.cfg)
    t = sum(3 * Y.wavernn_train_flops(d, s["B"], s["T"])
            for s in ctx.calls) / Y.PEAK_F32
    return 100.0 * t / ctx.window_s


def _stage_device_ms(ctx, stage):
    if stage not in ctx.stage_s or not ctx.calls:
        return None
    return 1e3 * ctx.stage_s[stage] / len(ctx.calls)


def voc_fwd_ms(ctx):
    """Device ms a training step of the operations launched in its
    ``forward`` stage (the trace, each op by its launch between the
    program's stage marks)."""
    return _stage_device_ms(ctx, "forward")


def voc_bwd_ms(ctx):
    """Device ms a training step of its ``backward`` stage's operations."""
    return _stage_device_ms(ctx, "backward")


def voc_opt_ms(ctx):
    """Device ms a training step of its ``optimizer`` stage's operations
    (the clip and Adam)."""
    return _stage_device_ms(ctx, "optimizer")


def step_device_ms(ctx):
    """Device ms a training step: the window's busy time over its steps."""
    if ctx.busy_s is None or not ctx.calls:
        return None
    return 1e3 * ctx.busy_s / len(ctx.calls)
