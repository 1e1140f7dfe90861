"""GRU training recurrence (kernel B5): the CUDA kernels' wrappers, the
autograd Function and the plain PyTorch versions.

Port of ``wavernn_tpu/ops/pallas_gru.py``: ``_make_fwd_kernel`` and
``_make_bwd_kernel`` behind the custom VJP ``gru_seq_tm``. Two bodies run
every step of one direction in one launch:

- ``csrc/gru_resident.cu``, which every B5 launch runs on: thread-block
  clusters, each owning a group of batch rows for all steps, its blocks
  holding the weights in shared memory split by hidden units and
  exchanging each step's rows through distributed shared memory; no grid
  barrier. ``resident_gru_plan`` mirrors its launch plan; launches count
  on ``gru_seq_tm.fwd_launches`` / ``bwd_launches``;
- ``csrc/gru_seq.cu``, the first body (one cooperative launch, a grid
  barrier every step), kept as the yardstick and reached only through the
  wrappers' private ``_legacy=True``; its launches count on
  ``gru_seq_tm.fwd_legacy_launches`` / ``bwd_legacy_launches``.

``gru_seq_ref`` and ``gru_seq_bwd_ref`` are the same two functions as
plain step loops, with the kernels' roundings: the streams (gi, ys, sv,
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


class _ResFwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("gi", "wh", "bh", "h0", "ys", "sv")]
                + [(f, ctypes.c_int64) for f in ("T", "B", "H", "bf16")])


class _ResBwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("sv", "ys", "dys", "whT", "h0", "dgi", "dgh", "dh0")]
                + [(f, ctypes.c_int64) for f in ("T", "B", "H", "bf16")])


# the resident body's launch plan, csrc/gru_resident.cu's GruResPlan field
# for field, and the constants its plan reads
RES_FIELDS = ("cluster", "clusters", "rows", "rb", "no", "units", "klen",
              "kp", "kres", "tasks", "ks", "kc", "push", "smem")
RES_THREADS = 256
RES_PMAX = 4                       # (row, unit) pairs a thread owns
RES_MAX_UNITS = RES_PMAX * RES_THREADS
RES_SMEM_BUDGET = 232448           # an H100 block's 227 KB
RES_SMEM_FLOOR = 118784            # two of these exceed an SM: one block each
RES_PREF_WEIGHTS = 64 * 1024
RES_MAX_CLUSTER = 16
RES_MAX_RB = 8


def _res_dims(backward, H, U, R):
    """(kp, weight floats a reduction index, lanes, outputs a task,
    exchange floats) of a block: forward the reduction over H, wh's 3U
    columns, U lanes, 3 outputs (the gates), the h_t slices; backward the
    reduction over the block's own 3U columns of dgh, the rows of wh^T for
    all H units, H / no lanes of no units each (2 where H is even and a
    thread gets two units), the partial dh of every unit."""
    if backward:
        no = 2 if H % 2 == 0 and H // 2 >= RES_THREADS else 1
        return (3 * U + 3) // 4 * 4, H, H // no, no, 2 * R * H
    return (H + 3) // 4 * 4, 3 * U, U, 3, 2 * R * U


def _res_rb(R):
    """Rows a task carries: all the cluster's, up to RES_MAX_RB."""
    return min(R, RES_MAX_RB)


def _res_ks(backward, P):
    return 1 if backward or P >= RES_THREADS else RES_THREADS // P


def _res_other_floats(backward, H, U, R):
    """Shared floats besides the weights: the tile, the two exchange
    buffers and (forward) the slices' partial sums."""
    kp, _, lanes, no, xb = _res_dims(backward, H, U, R)
    rb = _res_rb(R)
    rows = -(-R // rb) * rb
    P = lanes * (rows // rb)
    red = 0 if backward else _res_ks(False, P) * P * no * rb
    return rows * kp + xb + red


def resident_layout_floats(plan: dict, H: int, backward: bool) -> int:
    """Shared floats the kernel carves out for ``plan``: the weights, the
    tile or tiles, the exchange buffers, the partial sums and (push) the two
    mbarriers."""
    U, R, rb, kp = plan["units"], plan["rows"], plan["rb"], plan["kp"]
    rows = -(-R // rb) * rb
    if backward:
        return plan["kres"] * H + rows * kp + 2 * R * H + 4 * plan["push"]
    red = plan["ks"] * plan["tasks"] * 3 * rb
    if plan["push"]:
        return (plan["kres"] * 3 * U + 2 * plan["cluster"] * rows * U
                + (red + 1) // 2 * 2 + 4)
    return plan["kres"] * 3 * U + rows * kp + 2 * R * U + red


def resident_gru_plan(B: int, H: int, dtype, backward: bool, sms: int = 132,
                      max_cluster: int = RES_MAX_CLUSTER, active=None) -> dict:
    """The resident body's launch plan for B rows of H units, as
    ``csrc/gru_resident.cu``'s ``res_plan`` computes it: on a card with
    ``sms`` SMs whose largest cluster is ``max_cluster`` blocks and which
    holds ``active`` clusters of the chosen size at once (None: sms // C).
    The weights sit in shared memory in float32 for
    either stream dtype, so ``dtype`` does not change the plan.

    C is the smallest power of two whose blocks hold their share of wh
    beside one row, doubled while a block would hold more than
    RES_PREF_WEIGHTS bytes of it and B clusters of the doubled size still
    fit one block an SM; where no cluster holds wh, the largest, and the
    reduction indices from ``kres`` on read their weights from device
    memory every step. R, the rows a cluster owns, is the batch over the
    clusters the card holds at once, cut to what shared memory and the
    pairs a thread owns allow, then spread evenly over the clusters.
    The exchange is pushed (``push``) where the slices tile the rows
    exactly and the weights are resident: the forward's when two tiles fit,
    giving up at most half its reduction slices (``ks``), the backward's
    when its two mbarriers fit beside the partial buffers; else pulled
    after a cluster barrier. Fields: RES_FIELDS, plus ``k_global``
    (reduction indices whose weights are read from device memory) and
    ``threads``. Raises ValueError only where no cluster can hold one
    row."""
    del dtype
    budget = RES_SMEM_BUDGET // 4
    max_cluster = max(1, min(max_cluster, RES_MAX_CLUSTER))
    sms = max(1, sms)

    def units_of(c):
        return -(-H // c)

    def weights_of(c):
        kp, wpk = _res_dims(backward, H, units_of(c), 1)[:2]
        return kp * wpk

    sizes = []
    c = 1
    while c <= max_cluster:
        sizes.append(c)
        c *= 2
    C = 0
    for c in sizes:
        if units_of(c) > RES_MAX_UNITS:
            continue
        if weights_of(c) + _res_other_floats(backward, H, units_of(c),
                                             1) <= budget:
            C = c
            break
    if C == 0:
        fit = [c for c in sizes if units_of(c) <= RES_MAX_UNITS]
        if not fit:
            raise ValueError(f"no resident B5 plan holds H={H}")
        C = fit[-1]
    else:
        while (2 * C <= max_cluster and 4 * weights_of(C) > RES_PREF_WEIGHTS
               and B * 2 * C <= sms):
            C *= 2
    U = units_of(C)
    A = active if active else max(1, sms // C)
    R = max(1, -(-B // A))
    wfull = weights_of(C)
    resident = wfull + _res_other_floats(backward, H, U, 1) <= budget
    while R > 1 and (R * U > RES_MAX_UNITS
                     or (wfull if resident else 0)
                     + _res_other_floats(backward, H, U, R) > budget):
        R -= 1
    if _res_other_floats(backward, H, U, R) > budget:
        raise ValueError(f"no resident B5 plan holds a row of H={H}")
    N = max(1, -(-B // R))
    R = max(1, -(-B // N))     # the same clusters, rows spread evenly
    rb = _res_rb(R)
    kp, wpk, lanes, no = _res_dims(backward, H, U, R)[:4]
    free = budget - _res_other_floats(backward, H, U, R)
    kres = kp if resident else min(kp, free // wpk // 4 * 4)
    P = lanes * -(-R // rb)
    KS = _res_ks(backward, P)
    nbytes = 4 * (kres * wpk + _res_other_floats(backward, H, U, R))
    # the forward pushes its slices where they tile the rows exactly, the
    # weights are resident and two tiles fit, giving up at most half the
    # reduction's slices
    push = 0
    if (backward and resident and U % 4 == 0 and C * U == H
            and nbytes // 4 + 4 <= budget):
        push, nbytes = 1, nbytes + 16
    if not backward and resident and U % 4 == 0 and C * U == H:
        rows = -(-R // rb) * rb

        def need(ks):
            return (kp * wpk + 2 * C * rows * U
                    + (ks * P * 3 * rb + 1) // 2 * 2 + 4)
        ks = KS
        while ks > (KS + 1) // 2 and need(ks) > budget:
            ks -= 1
        if need(ks) <= budget:
            push, KS, nbytes = 1, ks, 4 * need(ks)
    kc = (-(-kp // KS) + 3) // 4 * 4
    smem = max(RES_SMEM_FLOOR, (nbytes + 15) // 16 * 16)
    klen = 3 * U if backward else H
    plan = dict(zip(RES_FIELDS, (C, N, R, rb, no, U, klen, kp, kres, P,
                                 KS, kc, push, smem)))
    plan.update(k_global=kp - kres, threads=RES_THREADS)
    return plan


def _res_lib():
    lib = _build.load("gru_resident")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_gru_res_fwd, lib.wr_gru_res_bwd):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wr_gru_res_plan.argtypes = [ctypes.c_int64] * 6 + [
            ctypes.c_void_p]
        lib.wr_gru_res_plan.restype = ctypes.c_int
        lib.wr_gru_res_card_plan.argtypes = [ctypes.c_int64] * 4 + [
            ctypes.c_void_p]
        lib.wr_gru_res_card_plan.restype = ctypes.c_int
        lib._typed = True
    return lib


def resident_plan_c(B: int, H: int, backward: bool, sms: int,
                    max_cluster: int, active: int = 0):
    """The kernel's own plan arithmetic (``wr_gru_res_plan``) for the same
    card figures as ``resident_gru_plan``: a dict of RES_FIELDS, or None
    where it has no plan."""
    out = (ctypes.c_int64 * len(RES_FIELDS))()
    if _res_lib().wr_gru_res_plan(B, H, int(backward), sms, max_cluster,
                                  active or 0, out):
        return None
    return dict(zip(RES_FIELDS, out))


def resident_launch_plan(B: int, H: int, dtype, backward: bool) -> dict:
    """The resident body's launch on the current card: RES_FIELDS, and the
    card's figures the plan read (``sms``, ``max_cluster``, ``active``:
    the clusters of the plan's size it holds at once)."""
    out = (ctypes.c_int64 * (len(RES_FIELDS) + 3))()
    err = _res_lib().wr_gru_res_card_plan(
        B, H, int(dtype == torch.bfloat16), int(backward), out)
    if err:
        raise RuntimeError(f"no resident GRU launch plan for B={B}, H={H}: "
                           f"CUDA error {err}")
    return dict(zip(RES_FIELDS + ("sms", "max_cluster", "active"), out))


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
    """The first body's launch for these shapes on the current card: hidden
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


def gru_seq_fwd(gi, wh, bh, h0, _legacy=False):
    """Forward over all steps: (ys, sv). CPU: ``gru_seq_ref``; CUDA: the
    resident body's forward kernel (``_legacy=True``: the first body's)."""
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
    ptrs = dict(gi=gi.data_ptr(), wh=wh.data_ptr(), bh=bh.data_ptr(),
                h0=h0.data_ptr(), ys=ys.data_ptr(), sv=sv.data_ptr(),
                T=T, B=B, H=H, bf16=int(dt == torch.bfloat16))
    if _legacy:
        _run(_lib().wr_gru_fwd, (dev, _FwdArgs(**ptrs)), "forward")
        gru_seq_tm.fwd_legacy_launches += 1
    else:
        _run(_res_lib().wr_gru_res_fwd, (dev, _ResFwdArgs(**ptrs)),
             "resident forward")
        gru_seq_tm.fwd_launches += 1
    return ys, sv


def gru_seq_bwd(sv, ys, wh, h0, dys, _legacy=False):
    """Backward over all steps: (dgi, dgh, dh0). CPU: ``gru_seq_bwd_ref``;
    CUDA: the resident body's backward kernel (``_legacy=True``: the first
    body's)."""
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
    common = dict(sv=sv.data_ptr(), ys=ys.data_ptr(), dys=dys.data_ptr(),
                  h0=h0.data_ptr(), dgi=dgi.data_ptr(), dgh=dgh.data_ptr(),
                  T=T, B=B, H=H, bf16=int(dt == torch.bfloat16))
    if _legacy:
        dtz = torch.empty(B, H, dtype=torch.float32, device=dev)
        args = _BwdArgs(wh=wh.data_ptr(), dh=dh.data_ptr(),
                        dtz=dtz.data_ptr(), **common)
        _run(_lib().wr_gru_bwd, (dev, args), "backward")
        gru_seq_tm.bwd_legacy_launches += 1
    else:
        # the rows of wh^T a block keeps, contiguous in units
        whT = wh.t().contiguous()
        args = _ResBwdArgs(whT=whT.data_ptr(), dh0=dh.data_ptr(), **common)
        _run(_res_lib().wr_gru_res_bwd, (dev, args), "resident backward")
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
gru_seq_tm.fwd_legacy_launches = 0
gru_seq_tm.bwd_legacy_launches = 0
