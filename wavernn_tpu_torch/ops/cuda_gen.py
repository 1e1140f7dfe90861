"""Fused WaveRNN sample loop: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``wavernn_tpu/ops/pallas_gen.py::generate_pallas_fused`` (the
``_make_fused_kernel`` TPU kernel). The kernel
(``csrc/sample_loop_fused.cu``) runs the whole autoregressive loop of every
fold in one cooperative launch and upsamples its own conditioning from the
frame-rate folded rows. ``generate_fused_ref`` is the same function in
plain PyTorch: the polyphase reconstruction followed by
``sample_loop.generate_scan``.

``generate_fused`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.

Noise: injected uniforms in the layout (T, B, NU), NU = nr_mix + 1 for MOL
(mixture pick | logistic draw) and n_classes for RAW, padded with 0.5 past
the given length; or, when none are given, the counter hash of
``counter_uniforms``, which the kernel evaluates in-kernel from the same
seed, so both versions draw the same numbers.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .polyphase import reconstruct_from_folded
from .sample_loop import generate_scan

_M32 = 0xFFFFFFFF
MOL_U_SCALE = 1.0 - 2e-5


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors x < 2**32 without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _lowbias32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def counter_uniforms(seed: int, T: int, B: int, nu: int, mol: bool,
                     device) -> torch.Tensor:
    """(T, B, nu) float32 uniforms of the kernel's counter hash: element
    (t, b, k) hashes the counter (t*B + b)*nu + k with the seed's key and
    keeps 24 bits. MOL maps them into [1e-5, 1-1e-5], RAW adds 1e-9."""
    key = _lowbias32_int(seed)
    ctr = torch.arange(T * B * nu, dtype=torch.int64, device=device) & _M32
    bits = _lowbias32(ctr ^ key) >> 8
    u = bits.to(torch.float32) * (2.0 ** -24)
    if mol:
        u = u * torch.tensor(MOL_U_SCALE, dtype=torch.float32, device=device)
        u = u + torch.tensor(1e-5, dtype=torch.float32, device=device)
    else:
        u = u + torch.tensor(1e-9, dtype=torch.float32, device=device)
    return u.reshape(T, B, nu)


def noise_stream(noise, T: int, mode: str) -> torch.Tensor:
    """Injected noise -> one (T, B, NU) float32 stream padded with 0.5."""
    if mode == "MOL":
        u_mix, u_s = noise
        u = torch.cat([u_mix, u_s[..., None]], dim=-1)
    else:
        u = noise
    u = u.to(torch.float32)
    if u.shape[0] < T:
        pad = u.new_full((T - u.shape[0],) + tuple(u.shape[1:]), 0.5)
        u = torch.cat([u, pad])
    return u[:T].contiguous()


def _split_noise(u, mode: str, nr_mix: int):
    return (u[..., :nr_mix], u[..., nr_mix]) if mode == "MOL" else u


def _dims(core):
    R = core["rnn1.weight_hh_l0"].shape[1]
    FC = core["fc2.weight"].shape[0]
    A = core["fc1.weight"].shape[1] - R
    NC = core["fc3.weight"].shape[0]
    n_mels = core["I.weight"].shape[1] - 1 - A
    return R, FC, A, NC, n_mels


def generate_fused_ref(core, frames, phi, hop: int, aux_tap: int,
                       fold_chunks: int, mode: str, noise=None,
                       seed: int = 0) -> torch.Tensor:
    """Plain version of the fused kernel: (num_folds, fold_chunks*hop)."""
    R, FC, A, NC, n_mels = _dims(core)
    B = frames.shape[1]
    T = fold_chunks * hop
    nr_mix = NC // 3
    mels_up, aux_up = reconstruct_from_folded(frames, phi, hop, aux_tap,
                                              fold_chunks, n_mels)
    if noise is None:
        u = counter_uniforms(seed, T, B, nr_mix + 1 if mode == "MOL" else NC,
                             mode == "MOL", frames.device)
    else:
        u = noise_stream(noise, T, mode)
    return generate_scan(core, mels_up, aux_up, mode,
                         _split_noise(u, mode, nr_mix))


_WEIGHT_FIELDS = ("w_imel", "w_ia1", "w_ix", "b_i", "wi1", "wh1", "bi1",
                  "bh1", "wi2x", "wi2a", "wh2", "bi2", "bh2", "w1x", "w1a",
                  "b1", "w2x", "w2a", "b2", "w3", "b3")
# kept float32 whatever the compute dtype: the biases, the sample-input
# column of I and fc3's bias (the x path and the logits are the
# numerically sensitive ends, as in the TPU kernel)
_F32_FIELDS = ("w_ix", "b_i", "bi1", "bh1", "bi2", "bh2", "b1", "b2", "b3")


def kernel_weights(core, compute_dtype=torch.bfloat16):
    """The kernel's weight operands: split, contiguous, matrices in
    ``compute_dtype`` (bfloat16 or float32), the rest float32."""
    R, FC, A, NC, n_mels = _dims(core)
    I_w = core["I.weight"]
    wi2 = core["rnn2.weight_ih_l0"]
    w1, w2 = core["fc1.weight"], core["fc2.weight"]
    parts = {
        "w_imel": I_w[:, 1:1 + n_mels], "w_ia1": I_w[:, 1 + n_mels:],
        "w_ix": I_w[:, 0], "b_i": core["I.bias"],
        "wi1": core["rnn1.weight_ih_l0"], "wh1": core["rnn1.weight_hh_l0"],
        "bi1": core["rnn1.bias_ih_l0"], "bh1": core["rnn1.bias_hh_l0"],
        "wi2x": wi2[:, :R], "wi2a": wi2[:, R:],
        "wh2": core["rnn2.weight_hh_l0"],
        "bi2": core["rnn2.bias_ih_l0"], "bh2": core["rnn2.bias_hh_l0"],
        "w1x": w1[:, :R], "w1a": w1[:, R:], "b1": core["fc1.bias"],
        "w2x": w2[:, :FC], "w2a": w2[:, FC:], "b2": core["fc2.bias"],
        "w3": core["fc3.weight"], "b3": core["fc3.bias"],
    }
    return {k: v.detach().to(torch.float32 if k in _F32_FIELDS
                              else compute_dtype).contiguous()
            for k, v in parts.items()}


def round_core_like_kernel(core, compute_dtype=torch.bfloat16):
    """The core weights with the kernel's roundings applied (matrices in
    ``compute_dtype``, back in float32): the plain version on these sees
    the numbers the kernel multiplies."""
    def rnd(v):
        return v.detach().to(compute_dtype).to(torch.float32)
    out = {}
    for k, v in core.items():
        if k == "I.weight":
            out[k] = torch.cat([v[:, :1].float(), rnd(v[:, 1:])], dim=1)
        elif k.endswith("bias") or "bias_" in k:
            out[k] = v.detach().float()
        else:
            out[k] = rnd(v)
    return out


class _FusedArgs(ctypes.Structure):
    _fields_ = ([("frames", ctypes.c_void_p), ("phi", ctypes.c_void_p),
                 ("noise", ctypes.c_void_p)]
                + [(f, ctypes.c_void_p) for f in _WEIGHT_FIELDS]
                + [("out", ctypes.c_void_p), ("work", ctypes.c_void_p)]
                + [(f, ctypes.c_int64) for f in
                   ("B", "R", "FC", "A", "n_mels", "NC", "K", "hop",
                    "fold_chunks", "aux_tap", "mol", "seed", "bf16")])


def _lib():
    lib = _build.load("sample_loop_fused")
    if not getattr(lib, "_typed", False):
        lib.wr_sample_loop_fused.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wr_sample_loop_fused.restype = ctypes.c_int
        lib.wr_sample_loop_fused_work_floats.argtypes = [ctypes.c_int64] * 4
        lib.wr_sample_loop_fused_work_floats.restype = ctypes.c_int64
        lib._typed = True
    return lib


def generate_fused(core, frames, phi, hop: int, aux_tap: int,
                   fold_chunks: int, mode: str, noise=None, seed: int = 0,
                   compute_dtype=torch.bfloat16):
    """Sample loop with in-kernel conditioning upsample.

    core: the vocoder's weights by reference state-dict name;
    frames (fold_chunks + K - 1, num_folds, n_mels + 4A) float32 from
    ``polyphase.build_folded_frames``; phi (K, hop) from ``phi_table``.
    noise: injected uniforms (see the module docstring) or None for the
    counter hash keyed by ``seed``.
    Returns samples (num_folds, fold_chunks*hop) float32.

    CPU tensors run the plain version (float32 throughout); CUDA tensors
    launch the kernel with matrices in ``compute_dtype``, split and cast
    once per weight set (``_build.prepared``)."""
    if frames.device.type == "cpu":
        return generate_fused_ref(core, frames, phi, hop, aux_tap,
                                  fold_chunks, mode, noise, seed)
    if frames.device.type != "cuda":
        raise ValueError(f"no fused sample loop for {frames.device}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute_dtype must be bfloat16 or float32, got "
                        f"{compute_dtype}")
    R, FC, A, NC, n_mels = _dims(core)
    K = phi.shape[0]
    nf_loc, B, C = frames.shape
    T = fold_chunks * hop
    mol = mode == "MOL"
    if mode not in ("MOL", "RAW"):
        raise ValueError(f"unknown mode {mode!r}")
    if R % 8 or FC % 8:
        raise ValueError("the kernel needs rnn_dims and fc_dims divisible "
                         "by 8")
    if mol and NC // 3 > 32:
        raise ValueError("the kernel samples at most 32 mixtures")
    dev = frames.device
    _build.check_operand(frames, "frames", torch.float32,
                         (fold_chunks + K - 1, B, n_mels + 4 * A), dev)
    _build.check_operand(phi, "phi", torch.float32, (K, hop), dev)
    if not 0 <= aux_tap < K:
        raise ValueError(f"aux_tap {aux_tap} outside the {K} frame taps")
    w = _build.prepared("sample_loop_fused", core, compute_dtype,
                        lambda: kernel_weights(core, compute_dtype))
    for k in _WEIGHT_FIELDS:
        want = torch.float32 if k in _F32_FIELDS else compute_dtype
        _build.check_operand(w[k], k, want, w[k].shape, dev)
    u = None
    if noise is not None:
        u = noise_stream(noise, T, mode)
        _build.check_operand(u, "noise", torch.float32,
                             (T, B, NC // 3 + 1 if mol else NC), dev)
    lib = _lib()
    out = torch.empty(B, T, dtype=torch.float32, device=dev)
    work = torch.zeros(lib.wr_sample_loop_fused_work_floats(B, R, FC, K),
                       dtype=torch.float32, device=dev)
    args = _FusedArgs(
        frames=frames.data_ptr(), phi=phi.data_ptr(),
        noise=None if u is None else u.data_ptr(),
        out=out.data_ptr(), work=work.data_ptr(),
        B=B, R=R, FC=FC, A=A, n_mels=n_mels, NC=NC, K=K, hop=hop,
        fold_chunks=fold_chunks, aux_tap=aux_tap, mol=int(mol),
        seed=seed & _M32, bf16=int(compute_dtype == torch.bfloat16),
        **{k: w[k].data_ptr() for k in _WEIGHT_FIELDS})
    with torch.cuda.device(dev):
        err = lib.wr_sample_loop_fused(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused sample-loop kernel launch failed: CUDA "
                           f"error {err}")
    generate_fused.launches += 1
    return out


generate_fused.launches = 0
