"""B10, the sample loop on pre-projected conditioning streams: the CUDA
kernel's wrapper and its plain PyTorch version (port of
``wavernn_tpu/ops/pallas_gen2.py``, the ``_make_kernel`` TPU kernel called
through ``generate_pallas_v2``).

Every product of the conditioning runs outside the loop, as whole-sequence
matrix products (``v2_streams``, pallas_gen2.py:167-182): five gate-space
streams rounded to ``stream_dtype``,

    i   = [mel | a1] @ W_Ic + b_I           (T, B, R)
    gi1 = i @ W_i1 + b_i1                   (T, B, 3R)
    gi2 = i @ W_i2x + a2 @ W_i2a + b_i2     (T, B, 3R)
    f1  = a3 @ W_1a + b_1,  f2 = a4 @ W_2a + b_2   (T, B, FC)

and the folded vectors wxw1 = W_i1 w_Ix, wxw2 = W_i2x w_Ix (float32,
:208-212). The loop then runs six products a step (pallas_gen2.py:88-144):
h1 @ W_h1, h1 @ W_i2x on the NEW h1 (the i part of xr @ W_i2x is in gi2),
h2 @ W_h2, fc1, fc2 and fc3. So with bf16 streams it is not the
materialized loop B3: ``i`` is rounded before xr = i + x w_Ix + h1, and
only its own plain loop, ``generate_v2_ref``, computes the same function.

The kernel is the ``ARM_V2`` arm of the resident body,
``csrc/sample_loop_resident.cu``, one cooperative launch per call: its
stage 1 is gate arithmetic at each unit's owner once the row's sample
arrives, and each block copies its step's slice of the streams, gathered
once per launch into the plan's unit order (``cuda_gen.gather_streams``),
a step ahead. The private ``_legacy=True`` runs the original body's arm
(``csrc/sample_loop_fused.cu``), the yardstick it is held to bit for bit.
Noise is the port's: injected uniforms in the (T, B, NU) layout of
``cuda_gen``, or the counter hash keyed by ``seed`` (the TPU kernel's
``pltpu.prng_random_bits`` in RAW mode, pallas_gen2.py:128-133, has no
counterpart). The TPU's ``chunk`` and ``T_pad`` are grid artefacts and are
dropped.
"""
from __future__ import annotations

import torch

from ..models.distribution import (
    sample_from_discretized_mix_logistic_with_noise,
    sample_raw_categorical_with_noise,
)
from . import _build
from .cuda_gen import (_M32, _WEIGHT_FIELDS, _LoopArgs, _check_kernel_call,
                       _count, _dims, _launch, _lib, _prof_buffer,
                       _prof_split, _ptr, _resident_launch, _sparse_args,
                       _uniforms, noise_stream)
from .layers import gru_gates, linear

_STREAM_DTYPES = (torch.bfloat16, torch.float32)


def v2_streams(core, mels_up, aux, stream_dtype=torch.bfloat16):
    """The five conditioning streams, time-major (T, B, width) and
    contiguous in ``stream_dtype``, in the order (i, gi1, gi2, f1, f2); and
    the float32 vectors (w_Ix, wxw1, wxw2). mels_up (B, T, n_mels), aux
    (B, T, 4A) float32; the products run in float32 on their device."""
    R, FC, A, _, _ = _dims(core)
    a1, a2, a3, a4 = (aux[..., k * A:(k + 1) * A] for k in range(4))
    I_w = core["I.weight"]
    wi1, wi2 = core["rnn1.weight_ih_l0"], core["rnn2.weight_ih_l0"]
    w1, w2 = core["fc1.weight"], core["fc2.weight"]
    i_cond = linear(torch.cat([mels_up, a1], dim=-1), I_w[:, 1:],
                    core["I.bias"])
    gi1 = linear(i_cond, wi1, core["rnn1.bias_ih_l0"])
    gi2 = (linear(i_cond, wi2[:, :R]) + linear(a2, wi2[:, R:])
           + core["rnn2.bias_ih_l0"])
    f1 = linear(a3, w1[:, R:], core["fc1.bias"])
    f2 = linear(a4, w2[:, FC:], core["fc2.bias"])
    streams = tuple(s.transpose(0, 1).to(stream_dtype).contiguous()
                    for s in (i_cond, gi1, gi2, f1, f2))
    w_x = I_w[:, 0].float()
    vecs = (w_x.contiguous(), (wi1.float() @ w_x).contiguous(),
            (wi2[:, :R].float() @ w_x).contiguous())
    return streams, vecs


def generate_v2_ref(core, mels_up, aux, mode: str, noise=None, seed: int = 0,
                    compute_dtype=torch.float32, stream_dtype=torch.bfloat16):
    """Plain version of B10: ``v2_streams`` and then ``v2_loop_ref``, the
    TPU kernel's step loop on the rounded streams. Returns samples (B, T)
    float32."""
    streams, vecs = v2_streams(core, mels_up, aux, stream_dtype)
    return v2_loop_ref(core, streams, vecs, mode, noise, seed, compute_dtype)


def v2_loop_ref(core, streams, vecs, mode: str, noise=None, seed: int = 0,
                compute_dtype=torch.float32):
    """Plain version of B10's launch (``launch_v2``): the step loop of
    pallas_gen2.py:88-144 on the streams and vectors of ``v2_streams``,
    the six per-step matrices (W_h1, W_i2x, W_h2, W_1x, W_2x, W_3) rounded
    to ``compute_dtype`` and multiplied in float32, as the kernel
    multiplies them. Returns samples (B, T) float32."""
    T, B, _ = streams[0].shape
    R, FC, A, NC, _ = _dims(core)
    w_x, wxw1, wxw2 = vecs
    s_i, s_g1, s_g2, s_f1, s_f2 = (s.float() for s in streams)

    def rnd(w):
        return w.detach().to(compute_dtype).float()
    wi2, w1, w2 = (core["rnn2.weight_ih_l0"], core["fc1.weight"],
                   core["fc2.weight"])
    wh1, wi2x = rnd(core["rnn1.weight_hh_l0"]), rnd(wi2[:, :R])
    wh2, w1x, w2x = rnd(core["rnn2.weight_hh_l0"]), rnd(w1[:, :R]), rnd(
        w2[:, :FC])
    w3 = rnd(core["fc3.weight"])
    bh1, bh2 = core["rnn1.bias_hh_l0"].float(), core["rnn2.bias_hh_l0"].float()
    b3 = core["fc3.bias"].float()
    u = _uniforms(noise, seed, T, B, mode, NC, s_i.device)
    h1 = s_i.new_zeros(B, R)
    h2 = s_i.new_zeros(B, R)
    x = s_i.new_zeros(B)
    out = []
    for t in range(T):
        xc = x[:, None]
        h1_new = gru_gates(s_g1[t] + xc * wxw1, linear(h1, wh1, bh1), h1)
        xr = (s_i[t] + xc * w_x) + h1_new
        gi2 = (s_g2[t] + xc * wxw2) + linear(h1_new, wi2x)
        h2 = gru_gates(gi2, linear(h2, wh2, bh2), h2)
        h1 = h1_new
        x2 = xr + h2
        hf = torch.relu(linear(x2, w1x) + s_f1[t])
        hf = torch.relu(linear(hf, w2x) + s_f2[t])
        logits = linear(hf, w3, b3)
        if mode == "MOL":
            x = sample_from_discretized_mix_logistic_with_noise(
                logits, u[0][t], u[1][t])
        else:
            x = sample_raw_categorical_with_noise(logits, u[t])
        out.append(x)
    return torch.stack(out, dim=1)


def generate_v2(core, mels_up, aux, mode: str, noise=None, seed: int = 0,
                compute_dtype=torch.bfloat16, stream_dtype=torch.bfloat16,
                _legacy: bool = False):
    """B10: the sample loop on pre-projected streams, one launch.

    core: the vocoder's weights by reference state-dict name; mels_up
    (B, T, n_mels), aux (B, T, 4A) float32 sample-rate conditioning (as
    ``generate_materialized`` takes it); noise: injected uniforms
    (T, B, ...) or None for the counter hash keyed by ``seed``. The streams
    are rounded to ``stream_dtype`` (bfloat16 or float32) on either device.
    Returns samples (B, T) float32, starting from a zero state.

    CPU tensors run the plain version (float32 matrices); CUDA tensors
    project the streams with ``torch`` matrix products and launch the
    kernel with the per-step matrices in ``compute_dtype`` (``_legacy``:
    on the original body, the yardstick)."""
    if stream_dtype not in _STREAM_DTYPES:
        raise TypeError(f"stream_dtype must be bfloat16 or float32, got "
                        f"{stream_dtype}")
    if mels_up.device.type == "cpu":
        return generate_v2_ref(core, mels_up, aux, mode, noise, seed,
                               stream_dtype=stream_dtype)
    if mels_up.device.type != "cuda":
        raise ValueError(f"no pre-projected sample loop for {mels_up.device}")
    _, _, A, _, n_mels = _dims(core)
    B, T, _ = mels_up.shape
    if tuple(mels_up.shape) != (B, T, n_mels) or tuple(aux.shape) != (
            B, T, 4 * A):
        raise ValueError(f"mels_up {tuple(mels_up.shape)} and aux "
                         f"{tuple(aux.shape)} do not match the weights' "
                         f"(B, T, {n_mels}) and (B, T, {4 * A})")
    streams, vecs = v2_streams(core, mels_up, aux, stream_dtype)
    return launch_v2(core, streams, vecs, mode, noise, seed, compute_dtype,
                     _legacy)


def launch_v2(core, streams, vecs, mode: str, noise=None, seed: int = 0,
              compute_dtype=torch.bfloat16, _legacy: bool = False):
    """B10's one launch on streams already projected: ``streams`` and
    ``vecs`` as ``v2_streams`` returns them, CUDA tensors; the other
    arguments as ``generate_v2``'s. Returns samples (B, T) float32. CPU
    tensors run the plain version (``v2_loop_ref``, float32 matrices)."""
    if streams[0].device.type == "cpu":
        return v2_loop_ref(core, streams, vecs, mode, noise, seed)
    out = _v2_launch(core, streams, vecs, mode, noise, seed, compute_dtype,
                     not _legacy)
    _count(generate_v2, not _legacy, False)
    return out


def generate_v2_profiled(core, streams, vecs, mode: str, seed: int = 0):
    """``launch_v2`` on the resident body's profiling instantiation
    (bfloat16 matrices, the counter hash): its samples and the per-stage
    split of a step, as ``cuda_gen.generate_fused_profiled`` returns it.
    Not a serving path; its launches are not counted."""
    prof = _prof_buffer(streams[0].device)
    out = _v2_launch(core, streams, vecs, mode, None, seed, torch.bfloat16,
                     True, prof)
    return (out,) + _prof_split(prof)


def _v2_launch(core, streams, vecs, mode, noise, seed, compute_dtype,
               resident, prof=None):
    """One launch of B10 on CUDA streams, on the resident body or
    (``resident`` False) the original body."""
    dev = streams[0].device
    if dev.type != "cuda":
        raise ValueError(f"no pre-projected sample loop for {dev}")
    w = _check_kernel_call(core, mode, compute_dtype, dev)
    R, FC, A, NC, n_mels = _dims(core)
    T, B, _ = streams[0].shape
    stream_dtype = streams[0].dtype
    if stream_dtype not in _STREAM_DTYPES:
        raise TypeError(f"streams must be bfloat16 or float32, got "
                        f"{stream_dtype}")
    if T < 1:
        raise ValueError("the sample loop needs at least one step")
    for s, name, width in zip(streams, ("i", "gi1", "gi2", "f1", "f2"),
                              (R, 3 * R, 3 * R, FC, FC)):
        _build.check_operand(s, name, stream_dtype, (T, B, width), dev)
    for v, name, n in zip(vecs, ("w_ix", "wxw1", "wxw2"), (R, 3 * R, 3 * R)):
        _build.check_operand(v, name, torch.float32, (n,), dev)
    mol = mode == "MOL"
    u = None
    if noise is not None:
        u = noise_stream(noise, T, mode)
        _build.check_operand(u, "noise", torch.float32,
                             (T, B, NC // 3 + 1 if mol else NC), dev)
    out = torch.empty(B, T, dtype=torch.float32, device=dev)
    if resident:
        _resident_launch(
            "wr_resident_v2" if prof is None else "wr_resident_profile", w,
            dev, compute_dtype, B, 0, prof, None, streams, noise=_ptr(u),
            out=out.data_ptr(), wxw1=vecs[1].data_ptr(),
            wxw2=vecs[2].data_ptr(), R=R, FC=FC, A=A, n_mels=n_mels, NC=NC,
            hop=1, T=T, snapshot_at=T, mol=int(mol), seed=seed & _M32)
        return out
    work = torch.zeros(_lib().wr_sample_loop_work_floats(B, R, FC, 0, 0),
                       dtype=torch.float32, device=dev)
    args = _LoopArgs(
        noise=_ptr(u),
        out=out.data_ptr(), work=work.data_ptr(),
        s_i=streams[0].data_ptr(), s_gi1=streams[1].data_ptr(),
        s_gi2=streams[2].data_ptr(), s_f1=streams[3].data_ptr(),
        s_f2=streams[4].data_ptr(), wxw1=vecs[1].data_ptr(),
        wxw2=vecs[2].data_ptr(),
        B=B, R=R, FC=FC, A=A, n_mels=n_mels, NC=NC, K=0, hop=1,
        fold_chunks=0, aux_tap=0, T=T, span=T, snapshot_at=T,
        mol=int(mol), seed=seed & _M32,
        bf16=int(compute_dtype == torch.bfloat16),
        stream_bf16=int(stream_dtype == torch.bfloat16),
        sp=_sparse_args(None, compute_dtype, dev),
        **{k: w[k].data_ptr() for k in _WEIGHT_FIELDS})
    _launch("wr_sample_loop_v2", args, dev, "pre-projected sample-loop")
    return out


# launches of B10 (through generate_v2 or launch_v2) on either body; on the
# resident body; on the original body (the private yardstick)
generate_v2.launches = 0
generate_v2.resident_launches = 0
generate_v2.legacy_launches = 0
