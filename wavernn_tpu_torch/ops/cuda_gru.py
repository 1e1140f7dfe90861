"""GRU training recurrence (kernel B5): the CUDA kernels' wrappers, the
autograd Function and the plain PyTorch versions.

Port of ``wavernn_tpu/ops/pallas_gru.py``: ``_make_fwd_kernel`` and
``_make_bwd_kernel`` behind the custom VJP ``gru_seq_tm``. The kernels
(``csrc/gru_seq.cu``) run every step of one direction in one cooperative
launch. ``gru_seq_ref`` and ``gru_seq_bwd_ref`` are the same two functions
as plain step loops, with the kernels' roundings: the streams (gi, ys, sv,
dgi, dgh) in the input dtype, bh read in float32, products accumulated in
float32, h rounded to the stream dtype every step, and the backward's dh
carried in float32.

Everything is time-major: gi (T, B, 3H) = x @ wi + bi computed outside,
wh (H, 3H) in the JAX layout (torch's ``weight_hh`` transposed), bh (3H,),
h0 (B, H); the output ys is (T, B, H). Gate math is torch's [r, z, n]:
n = tanh(gi_n + r * (h @ wh_n + bh_n)).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. Neither falls back to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(dt):
    """float32 accumulation for float32 and bfloat16 streams, as the
    kernels; float64 stays float64 (the gradient checks)."""
    return torch.promote_types(dt, torch.float32)


def gru_seq_ref(gi, wh, bh, h0):
    """Plain forward: (ys (T, B, H), sv (T, B, 4H) packed [r|z|n|hn]),
    both in gi's dtype. Differentiable by autograd."""
    dt = gi.dtype
    acc = _acc_dtype(dt)
    H = h0.shape[-1]
    whf = wh.to(dt).to(acc)
    bhf = bh.to(acc)
    h = h0.to(dt)
    ys, sv = [], []
    for t in range(gi.shape[0]):
        gh = h.to(acc) @ whf + bhf
        g = gi[t].to(acc)
        r = torch.sigmoid(g[:, :H] + gh[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        hn = gh[:, 2 * H:]
        n = torch.tanh(g[:, 2 * H:] + r * hn)
        h = ((1.0 - z) * n + z * h.to(acc)).to(dt)
        ys.append(h)
        sv.append(torch.cat([r, z, n, hn], dim=-1).to(dt))
    return torch.stack(ys), torch.stack(sv)


def gru_seq_bwd_ref(sv, ys, wh, h0, dys):
    """Plain backward, the reverse sweep of ``pallas_gru.py:138-166`` step by
    step: (dgi, dgh) (T, B, 3H) in sv's dtype and dh0 (B, H) in float32
    (float64 for float64 streams).
    dgh differs from dgi only in the n slot: dhn = dpre_n * r there."""
    dt = sv.dtype
    acc = _acc_dtype(dt)
    T, B, G4 = sv.shape
    H = G4 // 4
    whf = wh.to(dt).to(acc)
    dh = torch.zeros(B, H, dtype=acc, device=sv.device)
    dgi, dgh = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        s = sv[t].to(acc)
        r, z = s[:, :H], s[:, H:2 * H]
        n, hn = s[:, 2 * H:3 * H], s[:, 3 * H:]
        hp = (ys[t - 1] if t > 0 else h0.to(dt)).to(acc)
        dtot = dh + dys[t].to(acc)
        dz = dtot * (hp - n)
        dn = dtot * (1.0 - z)
        dpre_n = dn * (1.0 - n * n)
        dhn = dpre_n * r
        dpre_r = (dpre_n * hn) * r * (1.0 - r)
        dpre_z = dz * z * (1.0 - z)
        dgh[t] = torch.cat([dpre_r, dpre_z, dhn], dim=-1).to(dt)
        dgi[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1).to(dt)
        dh = dtot * z + dgh[t].to(acc) @ whf.t()
    return torch.stack(dgi), torch.stack(dgh), dh


class _FwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("gi", "wh", "bh", "h0", "ys", "sv")]
                + [(f, ctypes.c_int64) for f in ("T", "B", "H", "bf16")])


class _BwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("sv", "ys", "dys", "wh", "h0", "dgi", "dgh", "dh", "dtz")]
                + [(f, ctypes.c_int64) for f in ("T", "B", "H", "bf16")])


def _lib():
    lib = _build.load("gru_seq")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_gru_fwd, lib.wr_gru_bwd):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wr_gru_plan.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        lib.wr_gru_plan.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_plan(B: int, H: int, dtype, backward: bool) -> dict:
    """The kernel's launch for these shapes on the current card: hidden
    units per block, blocks, the forward's batch tile, shared bytes."""
    out = (ctypes.c_int64 * 4)()
    err = _lib().wr_gru_plan(B, H, int(dtype == torch.bfloat16),
                             int(backward), out)
    if err:
        raise RuntimeError(f"no GRU kernel launch fits B={B}, H={H}: CUDA "
                           f"error {err}")
    return dict(zip(("units", "blocks", "batch_tile", "smem_bytes"), out))


def _check_stream_dtype(dt):
    if dt not in _STREAM_DTYPES:
        raise TypeError(f"the GRU kernels take float32 or bfloat16 streams, "
                        f"got {dt}")


def _run(fn, args, what: str):
    with torch.cuda.device(args[0]):
        err = fn(ctypes.byref(args[1]),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"GRU {what} kernel launch failed: CUDA error "
                           f"{err}")


def gru_seq_fwd(gi, wh, bh, h0):
    """Forward over all steps: (ys, sv). CPU: ``gru_seq_ref``; CUDA: the
    forward kernel."""
    if gi.device.type == "cpu":
        return gru_seq_ref(gi, wh, bh, h0)
    if gi.device.type != "cuda":
        raise ValueError(f"no GRU recurrence kernel for {gi.device}")
    dt = gi.dtype
    _check_stream_dtype(dt)
    T, B, G = gi.shape
    H = G // 3
    dev = gi.device
    gi = gi.contiguous()
    wh = wh.to(dt).contiguous()
    bh = bh.to(torch.float32).contiguous()
    h0 = h0.to(dt).contiguous()
    _build.check_operand(gi, "gi", dt, (T, B, 3 * H), dev)
    _build.check_operand(wh, "wh", dt, (H, 3 * H), dev)
    _build.check_operand(bh, "bh", torch.float32, (3 * H,), dev)
    _build.check_operand(h0, "h0", dt, (B, H), dev)
    ys = torch.empty(T, B, H, dtype=dt, device=dev)
    sv = torch.empty(T, B, 4 * H, dtype=dt, device=dev)
    args = _FwdArgs(gi=gi.data_ptr(), wh=wh.data_ptr(), bh=bh.data_ptr(),
                    h0=h0.data_ptr(), ys=ys.data_ptr(), sv=sv.data_ptr(),
                    T=T, B=B, H=H, bf16=int(dt == torch.bfloat16))
    _run(_lib().wr_gru_fwd, (dev, args), "forward")
    gru_seq_tm.fwd_launches += 1
    return ys, sv


def gru_seq_bwd(sv, ys, wh, h0, dys):
    """Backward over all steps: (dgi, dgh, dh0). CPU: ``gru_seq_bwd_ref``;
    CUDA: the backward kernel."""
    if sv.device.type == "cpu":
        return gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    if sv.device.type != "cuda":
        raise ValueError(f"no GRU recurrence kernel for {sv.device}")
    dt = sv.dtype
    _check_stream_dtype(dt)
    T, B, G4 = sv.shape
    H = G4 // 4
    dev = sv.device
    wh = wh.to(dt).contiguous()
    h0 = h0.to(dt).contiguous()
    dys = dys.to(dt).contiguous()
    for t, name, shape in ((sv, "sv", (T, B, 4 * H)), (ys, "ys", (T, B, H)),
                           (dys, "dys", (T, B, H)), (wh, "wh", (H, 3 * H)),
                           (h0, "h0", (B, H))):
        _build.check_operand(t, name, dt, shape, dev)
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)  # dh_T = 0
    dgi = torch.empty(T, B, 3 * H, dtype=dt, device=dev)
    dgh = torch.empty(T, B, 3 * H, dtype=dt, device=dev)
    dtz = torch.empty(B, H, dtype=torch.float32, device=dev)
    args = _BwdArgs(sv=sv.data_ptr(), ys=ys.data_ptr(), dys=dys.data_ptr(),
                    wh=wh.data_ptr(), h0=h0.data_ptr(), dgi=dgi.data_ptr(),
                    dgh=dgh.data_ptr(), dh=dh.data_ptr(), dtz=dtz.data_ptr(),
                    T=T, B=B, H=H, bf16=int(dt == torch.bfloat16))
    _run(_lib().wr_gru_bwd, (dev, args), "backward")
    gru_seq_tm.bwd_launches += 1
    return dgi, dgh, dh


def weight_grads(ys, h0, dgh, wh_dtype, bh_dtype):
    """dwh = h_prev^T @ dgh as ONE matrix product over T*B (h_prev =
    [h0; ys[:-1]]), dbh = dgh summed in float32 (``pallas_gru.py:237-250``)."""
    T, B, H = ys.shape
    hprev = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
    dwh = torch.matmul(hprev.reshape(T * B, H).t(),
                       dgh.reshape(T * B, 3 * H)).to(wh_dtype)
    dbh = dgh.to(_acc_dtype(dgh.dtype)).sum(dim=(0, 1)).to(bh_dtype)
    return dwh, dbh


class _GruSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gi, wh, bh, h0):
        ys, sv = gru_seq_fwd(gi, wh, bh, h0)
        ctx.save_for_backward(sv, ys, wh, h0)
        ctx.bh_dtype = bh.dtype
        return ys

    @staticmethod
    def backward(ctx, dys):
        sv, ys, wh, h0 = ctx.saved_tensors
        dgi, dgh, dh0 = gru_seq_bwd(sv, ys, wh, h0, dys)
        dwh, dbh = weight_grads(ys, h0, dgh, wh.dtype, ctx.bh_dtype)
        return dgi, dwh, dbh, dh0.to(h0.dtype)


def gru_seq_tm(gi, wh, bh, h0):
    """Time-major GRU recurrence over a precomputed input stream, as the
    kernels: gi (T, B, 3H), wh (H, 3H), bh (3H,), h0 (B, H) -> ys (T, B, H),
    differentiable in all four. The weight gradients run outside the
    kernels as one matrix product each; dwi and dbi come from autograd
    through the caller's gi product."""
    return _GruSeq.apply(gi, wh, bh, h0)


gru_seq_tm.fwd_launches = 0
gru_seq_tm.bwd_launches = 0
