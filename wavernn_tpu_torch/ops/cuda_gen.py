"""WaveRNN sample loops: the CUDA kernels' wrappers and their plain
PyTorch versions.

Every CUDA sample loop runs on ``csrc/sample_loop_resident.cu`` (weights
resident in shared memory, activations read as step-tagged words instead
of behind a grid barrier, the conditioning built once per row; its launch
plan is ``resident_plan``): B1, B4b, B3 with B4a, B9's sparse arm of B1
and B3 (``sparse_packed=``) and B10 (``ops/cuda_gen2.py``). The original
body, ``csrc/sample_loop_fused.cu``, runs only through the wrappers'
private ``_legacy=True``: the yardstick each arm is held to bit for bit
and timed against. ``loop_body`` says which body a call runs on. The
kernels:

- B1, ``generate_fused``: port of
  ``wavernn_tpu/ops/pallas_gen.py::generate_pallas_fused`` (the
  ``_make_fused_kernel`` TPU kernel). It upsamples its own conditioning
  from frame-rate folded rows. ``generate_fused_ref`` is the plain version:
  the polyphase reconstruction followed by ``sample_loop.generate_scan``.
- B4b, ``generate_fused_with_state``: port of
  ``generate_pallas_fused_with_state`` (``_make_fused_kernel`` with
  ``with_state=True``, pallas_gen.py:856-873): B1 resuming from and
  snapshotting the RNN state, the exact-seam passes' kernel.
  ``generate_fused_with_state_ref`` is its plain version.
- B3, ``generate_materialized``: port of ``generate_pallas`` and
  ``generate_pallas_with_state`` (the ``_make_kernel`` TPU kernel, both
  arms). It reads sample-rate conditioning and resumes from and snapshots
  the RNN state. ``generate_materialized_ref`` is the plain version,
  ``sample_loop.generate_scan_with_state``.

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors; it never falls back from one to the other.

B9, block-sparse serving: ``pack_sparse`` packs the live (128, 128) blocks
of a pruned vocoder's weights once (port of ``pack_sparse`` and
``_pack_block_sparse``, wavernn_tpu/ops/pallas_gen.py:176-212, :412-458).
Given ``sparse_packed=``, both kernels launch their sparse arm, which
multiplies only the live 8-column chunks of the six per-step matrices'
rows and polls only the activations those chunks read (the ``_sparse_mm``
product, :119-173; its per-block table is ``resident_sparse_table``);
``sparse_mm_ref`` is its plain version, and the plain sample loops take
it for every packed matrix.

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
from .sample_loop import generate_scan_with_state

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
                       seed: int = 0, sparse_packed=None) -> torch.Tensor:
    """Plain version of the fused kernel: (num_folds, fold_chunks*hop).
    ``sparse_packed``: the per-step products of the packed matrices over
    their live blocks (``sparse_mm_ref``)."""
    return generate_fused_with_state_ref(
        core, frames, phi, hop, aux_tap, fold_chunks, mode, noise, seed,
        sparse_packed=sparse_packed)[0]


def generate_fused_with_state_ref(core, frames, phi, hop: int, aux_tap: int,
                                  fold_chunks: int, mode: str, noise=None,
                                  seed: int = 0, init_state=None,
                                  state_snapshot_at=None, sparse_packed=None):
    """Plain version of the fused kernel with state I/O: the polyphase
    reconstruction, then ``generate_scan_with_state`` from ``init_state``
    with the snapshot at ``state_snapshot_at``. Returns (samples
    (num_folds, fold_chunks*hop), (h1, h2, x))."""
    _, _, _, NC, n_mels = _dims(core)
    B = frames.shape[1]
    T = fold_chunks * hop
    mels_up, aux_up = reconstruct_from_folded(frames, phi, hop, aux_tap,
                                              fold_chunks, n_mels)
    return generate_scan_with_state(
        core, mels_up, aux_up, mode,
        _uniforms(noise, seed, T, B, mode, NC, frames.device),
        init_state, state_snapshot_at, _active_pack(core, sparse_packed))


def _uniforms(noise, seed: int, T: int, B: int, mode: str, NC: int, device):
    """The plain versions' noise: the injected stream or the counter hash,
    split as ``generate_scan`` takes it."""
    nr_mix = NC // 3
    if noise is None:
        u = counter_uniforms(seed, T, B, nr_mix + 1 if mode == "MOL" else NC,
                             mode == "MOL", device)
    else:
        u = noise_stream(noise, T, mode)
    return _split_noise(u, mode, nr_mix)


def generate_materialized_ref(core, mels_up, aux, mode: str, noise=None,
                              seed: int = 0, init_state=None,
                              state_snapshot_at=None, sparse_packed=None):
    """Plain version of the materialized kernel: the sample loop over
    sample-rate conditioning with the RNN state in and out
    (``sample_loop.generate_scan_with_state``), the packed matrices'
    per-step products over their live blocks.
    Returns (samples (B, T), (h1 (B, R), h2 (B, R), x (B,)))."""
    B, T, _ = mels_up.shape
    NC = _dims(core)[3]
    return generate_scan_with_state(
        core, mels_up, aux, mode,
        _uniforms(noise, seed, T, B, mode, NC, mels_up.device),
        init_state, state_snapshot_at, _active_pack(core, sparse_packed))


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


# ---- B9: block-sparse packing and the plain block-sparse product ----

SPARSE_BC = 128        # output rows per block
SPARSE_BR_MXU = 128    # input columns per block: the production schedule
SPARSE_BR = 8          # the legacy allow_br8 schedule
# the six matrices whose per-step products the kernels' sparse arm reads,
# in the order of LoopArgs::sp
STEP_MATRICES = ("wi1", "wh1", "wi2x", "wh2", "w1x", "w2x")
_PACK_SOURCES = ("rnn1.weight_ih_l0", "rnn1.weight_hh_l0",
                 "rnn2.weight_ih_l0", "rnn2.weight_hh_l0", "fc1.weight",
                 "fc2.weight")


class SparseMatrix:
    """One packed matrix (out, in): ``rows[j]``, the live input blocks of
    output block j in increasing order; ``blocks`` (L, 128, br) float32,
    the live blocks in (j, input block) order."""

    def __init__(self, br: int, rows, blocks, shape):
        self.br, self.rows, self.blocks = br, rows, blocks
        self.shape = tuple(shape)
        self._on = {}

    def live(self) -> int:
        return sum(len(r) for r in self.rows)

    def on(self, device):
        """(input block, output block) of each live block, and the blocks,
        on ``device``; made once per device."""
        if device not in self._on:
            cols = [r for rj in self.rows for r in rj]
            dst = [j for j, rj in enumerate(self.rows) for _ in rj]
            self._on[device] = (torch.tensor(cols, device=device),
                                torch.tensor(dst, device=device),
                                self.blocks.to(device))
        return self._on[device]


def _pack_block_sparse(W, max_density: float = 0.5, br: int = SPARSE_BR_MXU):
    """A masked weight (out, in) as a SparseMatrix of its live (128, br)
    blocks, or None when more than ``max_density`` of its blocks are live
    or its shape does not tile. A block is dead when every entry is exactly
    zero, so skipping it changes no sum."""
    W = W.detach().float()
    O, I = W.shape
    bc = SPARSE_BC
    if I % br or O % bc:
        return None
    keep = (W.abs().reshape(O // bc, bc, I // br, br).sum(dim=(1, 3))
            > 0.0).cpu()
    if keep.float().mean() > max_density:
        return None
    rows = tuple(tuple(int(r) for r in torch.nonzero(keep[j]).flatten())
                 for j in range(O // bc))
    lives = [(j, r) for j, rj in enumerate(rows) for r in rj]
    blocks = (torch.stack([W[j * bc:(j + 1) * bc, r * br:(r + 1) * br]
                           for j, r in lives]) if lives
              else W.new_zeros(0, bc, br))
    return SparseMatrix(br, rows, blocks.contiguous(), W.shape)


def sparse_mm_ref(op, m: SparseMatrix):
    """Plain version of the block-sparse product: op (B, in) @ W.T over
    the live blocks of W only -> (B, out) float32. Output blocks with no
    live block are exactly 0."""
    B = op.shape[0]
    O, I = m.shape
    bc, br = SPARSE_BC, m.br
    out = op.new_zeros(B, O // bc, bc, dtype=torch.float32)
    if m.blocks.shape[0]:
        cols, dst, blocks = m.on(op.device)
        opg = op.float().reshape(B, I // br, br)[:, cols]      # (B, L, br)
        part = torch.einsum("blk,lok->blo", opg, blocks)      # (B, L, 128)
        out.index_add_(1, dst, part)
    return out.reshape(B, O)


def _sources_sig(core):
    return tuple((k, core[k].device, core[k].data_ptr(), core[k]._version,
                  tuple(core[k].shape), core[k].dtype)
                 for k in _PACK_SOURCES)


class SparsePack:
    """``pack_sparse``'s result: the packed matrices by kernel name
    (``entries``), and the identity of the weights they were packed from.
    Opaque to callers; pass it as ``sparse_packed=``."""

    def __init__(self, entries, sig):
        self.entries = entries
        self._sig = sig
        self._operands = {}
        self._tables = {}   # resident_sparse_table by plan, on its device

    def mm(self, name: str, op):
        return sparse_mm_ref(op, self.entries[name])

    def check(self, core) -> None:
        """Raise unless the pack was made from these weights as they are
        now: an in-place update (a train step's masks, a load) makes it
        stale, and a stale pack would serve the old weights' values."""
        if _sources_sig(core) != self._sig:
            raise ValueError(
                "sparse_packed is stale: the vocoder's weights moved or "
                "changed since pack_sparse; pack them again")

    def kernel_operands(self, compute_dtype, dev):
        """Per STEP_MATRICES name: (row_ptr int32 (out/128 + 1), col int32
        (L,), blocks (L, 128, br) in ``compute_dtype``, br) on ``dev``, or
        None for a matrix that stays dense. Made once per dtype."""
        key = (compute_dtype, dev)
        if key not in self._operands:
            ops = []
            for name in STEP_MATRICES:
                m = self.entries.get(name)
                if m is None:
                    ops.append(None)
                    continue
                counts = [0] + [len(rj) for rj in m.rows]
                row_ptr = torch.tensor(counts, dtype=torch.int64).cumsum(0)
                col = [r for rj in m.rows for r in rj]
                ops.append((row_ptr.to(torch.int32).to(dev),
                            torch.tensor(col or [0], dtype=torch.int32,
                                         device=dev),
                            m.blocks.to(dev, compute_dtype).contiguous(),
                            m.br))
            self._operands[key] = ops
        return self._operands[key]


def pack_sparse(core, voc=None, allow_br8: bool = False) -> SparsePack:
    """One-time packing of a masked vocoder's zero-block pattern (the JAX
    package's ``pack_sparse``): the nine matrices of its ``host`` dict,
    each packed when at most half of its (128, 128) blocks are live and
    its shape tiles, else left dense. Whole blocks are (128 output rows,
    128 input columns); the ragged aux tails ``wi2a``, ``w1a``, ``w2a``
    (A input columns) do not tile and stay dense. ``allow_br8`` also
    tries (128 output rows, 8 input columns) blocks, the legacy schedule,
    for numerical tests of fine-grained masks.

    core: the vocoder's weights by reference state-dict name
    (``WaveRNN.core_weights()``); voc, when given, must name the same
    widths. Packing again from unchanged weights returns the same pack
    (``_build.prepared``'s rule); serving packs once after loading."""
    R = core["rnn1.weight_hh_l0"].shape[1]
    FC = core["fc2.weight"].shape[0]
    if voc is not None and (voc.rnn_dims, voc.fc_dims) != (R, FC):
        raise ValueError(f"voc widths ({voc.rnn_dims}, {voc.fc_dims}) do "
                         f"not match the weights' ({R}, {FC})")
    sources = {k: core[k] for k in _PACK_SOURCES}

    def make():
        wi2, w1, w2 = (core["rnn2.weight_ih_l0"], core["fc1.weight"],
                       core["fc2.weight"])
        host = {"wi1": core["rnn1.weight_ih_l0"],
                "wh1": core["rnn1.weight_hh_l0"],
                "wi2x": wi2[:, :R], "wi2a": wi2[:, R:],
                "wh2": core["rnn2.weight_hh_l0"],
                "w1x": w1[:, :R], "w1a": w1[:, R:],
                "w2x": w2[:, :FC], "w2a": w2[:, FC:]}
        brs = (SPARSE_BR_MXU, SPARSE_BR) if allow_br8 else (SPARSE_BR_MXU,)
        entries = {}
        for name, W in host.items():
            for br in brs:
                m = _pack_block_sparse(W, br=br)
                if m is not None:
                    entries[name] = m
                    break
        return SparsePack(entries, _sources_sig(core))
    return _build.prepared("pack_sparse", sources, allow_br8, make)


def _active_pack(core, sparse_packed):
    """The pack the sample loop runs with: None for no pack or an empty
    one (nothing sparse enough: the weights are served dense, as the JAX
    package serves them); raises on a stale pack."""
    if sparse_packed is None or not sparse_packed.entries:
        return None
    sparse_packed.check(core)
    return sparse_packed


class _SparseMat(ctypes.Structure):
    """``SparseMat`` of csrc/sample_loop_fused.cu."""
    _fields_ = [("row_ptr", ctypes.c_void_p), ("col", ctypes.c_void_p),
                ("val", ctypes.c_void_p), ("bw", ctypes.c_int64)]


class _LoopArgs(ctypes.Structure):
    """``LoopArgs`` of csrc/sample_loop_fused.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("frames", "phi", "cond", "noise")]
                + [(f, ctypes.c_void_p) for f in _WEIGHT_FIELDS]
                + [(f, ctypes.c_void_p) for f in
                   ("h1_0", "h2_0", "x_0", "snap_h1", "snap_h2", "snap_x",
                    "out", "work", "s_i", "s_gi1", "s_gi2", "s_f1", "s_f2",
                    "wxw1", "wxw2")]
                + [(f, ctypes.c_int64) for f in
                   ("B", "R", "FC", "A", "n_mels", "NC", "K", "hop",
                    "fold_chunks", "aux_tap", "T", "span", "snapshot_at",
                    "mol", "seed", "bf16", "stream_bf16")]
                + [("sp", _SparseMat * len(STEP_MATRICES))])


def _sparse_args(pack, compute_dtype, dev):
    """LoopArgs::sp for ``pack`` (all null, the dense arm, for None)."""
    sp = (_SparseMat * len(STEP_MATRICES))()
    if pack is not None:
        for i, ops in enumerate(pack.kernel_operands(compute_dtype, dev)):
            if ops is not None:
                row_ptr, col, val, br = ops
                sp[i] = _SparseMat(row_ptr.data_ptr(), col.data_ptr(),
                                   val.data_ptr(), br)
    return sp


def _lib():
    lib = _build.load("sample_loop_fused")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_sample_loop_fused, lib.wr_sample_loop_fused_state,
                   lib.wr_sample_loop_materialized, lib.wr_sample_loop_v2):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wr_sample_loop_work_floats.argtypes = [ctypes.c_int64] * 5
        lib.wr_sample_loop_work_floats.restype = ctypes.c_int64
        lib._typed = True
    return lib


# ---- the resident body (csrc/sample_loop_resident.cu) ----

# the shared memory one block may use on Hopper (H100, H200)
SMEM_BUDGET = 232_448
# fc3 stays in shared memory up to this size (MOL's 30 classes: 30 KB in
# bfloat16, 60 KB in float32); RAW's 512 classes read it from L2
W3_RESIDENT_MAX = 64 * 1024
# the kernel's warps a block and rows a warp takes in a GRU stage
RESIDENT_WARPS = 8
GRU_ROWS = 8
# the mel taps a sampling block preloads (the kernel's KMAX), and the
# columns of a conditioning dot (cond_dots: four a lane)
RESIDENT_MAX_TAPS = 8
RESIDENT_MAX_COND = 128
# ResArgs::off, in the kernel's Region order
RESIDENT_REGIONS = ("mbar", "sparse", "prof", "wi1", "wh1", "wi2x", "wh2",
                    "w1x", "w2x", "w3", "w_imel", "w_ia1", "wi2a", "w1a",
                    "w2a", "gh1", "gh2", "own_h1", "own_h2", "plane",
                    "x_own", "logits", "consts", "tile_a", "tile_b",
                    "x_all")
# where the kernel finds B9's table (its SPARSE_OFF): right after mbar
SPARSE_OFF = 16
# the conditioning matrices' rows, which B10 (its streams pre-projected)
# does not hold
COND_REGIONS = ("w_imel", "w_ia1", "wi2a", "w1a", "w2a")
# the regions that grow with the row count: the hidden sums, the owned
# units' state and the conditioning planes (block-private, so they may lie
# in device memory where shared memory is short)
ROW_REGIONS = ("gh1", "gh2", "own_h1", "own_h2", "plane")
_PROF_STAGES = ("prologue", "gru1", "gru2", "fc1", "fc2", "sample")
_PROF_KINDS = ("first_poll", "wait", "products", "draw", "deferred",
               "other")
# B9's fetch lists, in the kernel's List order: the chunks each poll reads
SPARSE_LISTS = ("v", "h1", "xr", "h2", "x2", "hf1")


class ResidentPlan:
    """The resident body's launch plan for one shape: ``G`` blocks (one per
    SM); block g owns the R-wide units ``units_r[g]`` of the GRU stages and
    the FC-wide units ``units_fc[g]`` of fc1/fc2 (-1 pads the slots it
    lacks); with ``exclusive``, the B sampling blocks own none, and fc3's
    rows (only they hold them) share the unit weights' bytes; the byte
    offset of each region (``offsets``, by RESIDENT_REGIONS name) and
    ``smem_bytes`` of shared memory in all; with ``rows_global``, the
    per-row regions (ROW_REGIONS) lie instead in a device buffer of
    ``row_bytes`` a block, their offsets counted from its slice;
    ``tile_rows`` rows of activations a fetch brings in; whether fc3's rows
    are resident (``w3_resident``). B9 (``sparse``): ``sparse_words`` of
    the block's table in shared memory; B10 (``v2``): ``slice_floats`` of
    stream a step and block, two slots of them in the plane region (none
    where the per-row regions lie in device memory: the kernel reads the
    gathered streams in place)."""

    def __init__(self, G, units_r, units_fc, sizes, tile_rows, w3_resident,
                 exclusive=False, alias_w3=False, rows_global=False,
                 sparse_words=0, slice_floats=0):
        self.G, self.units_r, self.units_fc = G, units_r, units_fc
        self.UR, self.UF = len(units_r[0]), len(units_fc[0])
        self.tile_rows, self.w3_resident = tile_rows, w3_resident
        self.exclusive, self.alias_w3 = exclusive, alias_w3
        self.rows_global = rows_global
        self.sparse_words, self.slice_floats = sparse_words, slice_floats
        self.sizes = sizes
        self.offsets, off, goff = {}, 0, 0
        for name in RESIDENT_REGIONS:
            size = -(-sizes[name] // 16) * 16
            if rows_global and name in ROW_REGIONS:
                self.offsets[name] = goff
                goff += size
                continue
            self.offsets[name] = off
            if not (alias_w3 and name == "w3"):
                off += size
        if alias_w3:
            self.offsets["w3"] = self.offsets["wi1"]
        self.smem_bytes, self.row_bytes = off, goff


def _own(n: int, G: int, first: int = 0):
    """Units 0..n-1 dealt to blocks first..G-1 in turn (block g's slot s:
    unit (g - first) + s*(G - first)); blocks below ``first`` own none."""
    owners = G - first
    per = -(-n // owners)
    return [[(g - first) + s * owners
             if g >= first and (g - first) + s * owners < n else -1
             for s in range(per)] for g in range(G)]


SPARSE_HEAD = 16   # the kernel's N_HEAD


def sparse_words(R: int, FC: int, UR: int, UF: int, G: int) -> int:
    """32-bit words of B9's per-block table: a 16-word header, the owned
    units' chunk masks (R units: 4 matrices x 3 gates, FC units: w1x and
    w2x; a word per 32 chunks of a row), 8 list lengths, the SPARSE_LISTS
    lists of uint16 chunk indices (an even count each), and a bit per
    block that owns a unit (the done words the samplers poll)."""
    nw_r, nw_f = -(-(R // 8) // 32), -(-(FC // 8) // 32)
    lmax = (max(R, FC) // 8 + 1) & ~1
    return (SPARSE_HEAD + UR * 12 * nw_r + UF * (nw_r + nw_f) + 8
            + len(SPARSE_LISTS) * lmax // 2 + -(-G // 32))


def v2_slice_floats(UR: int, UF: int, B: int) -> int:
    """Floats of B10's stream slice a block reads a step: gi2 (UR, 3, B),
    f1 and f2 (UF, B), gi1 (UR, 3, B), i (UR, B), padded to 16 bytes."""
    return -(-(7 * UR + 2 * UF) * B // 4) * 4


def resident_plan(R: int, FC: int, NC: int, A: int, n_mels: int, B: int,
                  sms: int, compute_dtype=torch.bfloat16, taps: int = 0,
                  budget: int = SMEM_BUDGET, sparse: bool = False,
                  v2: bool = False) -> ResidentPlan:
    """The resident body's plan for B rows on ``sms`` SMs with matrices in
    ``compute_dtype`` and ``taps`` mel taps (B1's K; B3, B10: 0): every
    block's owned units, region layout and tile rows (tile_b also holds a
    sampled row's base, taps and w_Ix: taps + 2 rows at least). The per-row
    regions stay in shared memory while a tile of min(B, GRU_ROWS) rows
    still fits beside them, else they move to device memory (many rows:
    from 378 at the default widths in bfloat16, from 65 in float32), so any
    row count runs. ``sparse``: B9's arm, with its table
    (``sparse_words``); ``v2``: B10's, without the conditioning matrices,
    its plane two slots of stream slices and the B samples in shared
    memory. Raises ValueError, naming the budget, when a block's weights
    and one row of tiles do not fit ``budget`` bytes."""
    if sms < 1 or B < 1:
        raise ValueError(f"need at least one SM and one row (sms {sms}, "
                         f"B {B})")
    if max(n_mels, A) > RESIDENT_MAX_COND:
        raise ValueError(f"the resident sample loop's conditioning dots take "
                         f"at most {RESIDENT_MAX_COND} columns a row: n_mels "
                         f"{n_mels}, aux_dims {A}")
    wb = 2 if compute_dtype == torch.bfloat16 else 4
    w3_resident = NC * FC * wb <= W3_RESIDENT_MAX
    # few rows: the sampling blocks own no unit, so the others' deferred
    # products and B3's conditioning run while the rows are sampled; only
    # while each of the others still has at most one GRU item a warp
    exclusive = (B < sms and -(-R // (sms - B)) * -(-B // GRU_ROWS)
                 <= RESIDENT_WARPS)
    first = B if exclusive else 0
    units_r, units_fc = _own(R, sms, first), _own(FC, sms, first)
    UR, UF = len(units_r[0]), len(units_fc[0])
    alias_w3 = exclusive and w3_resident and (
        NC * FC <= UR * 12 * R + UF * (R + FC))
    sw = sparse_words(R, FC, UR, UF, sms) if sparse else 0
    pbv = v2_slice_floats(UR, UF, B) if v2 else 0
    sizes = {"mbar": 32 if v2 else 16,
             "prof": 8 * len(_PROF_STAGES) * len(_PROF_KINDS),
             "wi1": UR * 3 * R * wb, "wh1": UR * 3 * R * wb,
             "wi2x": UR * 3 * R * wb, "wh2": UR * 3 * R * wb,
             "w1x": UF * R * wb, "w2x": UF * FC * wb,
             "w3": NC * FC * wb if w3_resident else 0,
             "w_imel": UR * n_mels * wb, "w_ia1": UR * A * wb,
             "wi2a": UR * 3 * A * wb, "w1a": UF * A * wb,
             "w2a": UF * A * wb,
             "gh1": UR * 3 * B * 4, "gh2": UR * 3 * B * 4,
             "own_h1": UR * B * 4, "own_h2": UR * B * 4,
             "plane": 2 * (3 * UR + 2 * UF) * B * 4,
             "x_own": -(-B // sms) * 4, "logits": NC * 4,
             "consts": (UR * 13 + UF * 2) * 4 + (UR + UF) * 4,
             "tile_a": 0, "tile_b": 0, "sparse": sw * 4,
             "x_all": B * 4 if v2 else 0}
    if v2:
        sizes.update({n: 0 for n in COND_REGIONS})
        sizes["plane"] = 2 * pbv * 4

    def tiles(rows):
        return rows * max(R, FC) * 4 + max(rows, taps + 2) * R * 4

    def tile_rows(rows_global):
        fixed = ResidentPlan(sms, units_r, units_fc, sizes, 0, w3_resident,
                             exclusive, alias_w3, rows_global).smem_bytes
        rows = max(0, min(B, (budget - fixed) // ((max(R, FC) + R) * 4)))
        while rows >= 1 and fixed + tiles(rows) > budget:
            rows -= 1
        return rows, fixed

    rows_global = False
    rows, fixed = tile_rows(False)
    if rows < min(B, GRU_ROWS):
        rows_global = True
        if v2:   # the kernel reads the gathered streams in place
            sizes["plane"] = 0
        rows, fixed = tile_rows(True)
    if rows < 1:
        raise ValueError(
            f"the resident sample loop needs {fixed + tiles(1):,} bytes of "
            f"shared memory a block (R {R}, FC {FC}, {NC} classes, {B} rows, "
            f"{compute_dtype} weights on {sms} SMs), over the {budget:,}-byte "
            "budget")
    sizes["tile_a"] = rows * max(R, FC) * 4
    sizes["tile_b"] = max(rows, taps + 2) * R * 4
    plan = ResidentPlan(sms, units_r, units_fc, sizes, rows, w3_resident,
                        exclusive, alias_w3, rows_global, sw, pbv)
    assert not sparse or plan.offsets["sparse"] == SPARSE_OFF
    return plan


def chunk_masks(pack: SparsePack, R: int, FC: int):
    """Per STEP_MATRICES name, (out, in / 8) bool: the live 8-column chunks
    of each row, from the pack's live blocks (``rows``; a (128, br) block
    covers br / 8 chunks of 128 rows); every chunk of a matrix the pack
    left dense."""
    shapes = {"wi1": (3 * R, R), "wh1": (3 * R, R), "wi2x": (3 * R, R),
              "wh2": (3 * R, R), "w1x": (FC, R), "w2x": (FC, FC)}
    out = {}
    for name in STEP_MATRICES:
        O, I = shapes[name]
        m = pack.entries.get(name)
        if m is None:
            out[name] = torch.ones(O, I // 8, dtype=torch.bool)
            continue
        blk = torch.zeros(O // SPARSE_BC, I // m.br, dtype=torch.bool)
        for j, rj in enumerate(m.rows):
            blk[j, list(rj)] = True
        out[name] = blk.repeat_interleave(SPARSE_BC, 0).repeat_interleave(
            m.br // 8, 1)
    return out


def _mask_words(mask):
    """(..., n) bool -> (..., ceil(n / 32)) int32: chunk c is bit c % 32 of
    word c // 32."""
    n = mask.shape[-1]
    nw = -(-n // 32)
    bits = torch.nn.functional.pad(mask.to(torch.int64), (0, nw * 32 - n))
    v = (bits.reshape(*mask.shape[:-1], nw, 32)
         << torch.arange(32, dtype=torch.int64)).sum(-1)
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def resident_sparse_table(plan: ResidentPlan, pack: SparsePack, R: int,
                          FC: int, B: int):
    """B9's per-block table for ``plan`` (G, sparse_words) int32, the
    kernel's layout: a header (the mask words a row of R and of FC
    columns, the list capacity, the offsets past the header of the w1x
    masks, the w2x masks, the list lengths and the acting-block bits, R,
    FC; words 10-11 the kernel fills), the owned units' chunk masks
    (``chunk_masks``; R units (UR, wi1 wh1 wi2x wh2, 3 gates, words), then
    w1x (UF, words) and w2x (UF, words); a padding slot's are 0), the
    SPARSE_LISTS lengths (8 ints), the lists (uint16 chunk indices in
    increasing order, two to a word), a bit per block that owns a unit. With one tile of rows (the block forms xr and x2 itself) v
    covers the chunks of wi1, wi2x and w1x; h1 those of wi2x, w1x and wh1;
    h2 those of w1x and wh2. With several (it reads xr and x2 as written)
    v covers wi1's and its own units', xr wi2x's and its own, h1 wh1's, x2
    w1x's, h2 wh2's. hf1 covers w2x's. v has at least chunk 0: stage 1
    polls every row."""
    G, UR, UF = plan.G, plan.UR, plan.UF
    masks = chunk_masks(pack, R, FC)
    ur, uf = torch.tensor(plan.units_r), torch.tensor(plan.units_fc)
    vr, vf = ur >= 0, uf >= 0
    urc, ufc = ur.clamp(min=0), uf.clamp(min=0)
    rm = torch.stack([torch.stack([masks[n][gt * R + urc] for gt in range(3)],
                                  dim=2)
                      for n in ("wi1", "wh1", "wi2x", "wh2")], dim=2)
    rm &= vr[:, :, None, None, None]               # (G, UR, 4, 3, R / 8)
    f1 = masks["w1x"][ufc] & vf[..., None]         # (G, UF, R / 8)
    f2 = masks["w2x"][ufc] & vf[..., None]         # (G, UF, FC / 8)
    words = torch.cat([_mask_words(m).reshape(G, -1) for m in (rm, f1, f2)],
                      dim=1)

    def over_units(m):
        return m.reshape(G, -1, m.shape[-1]).any(dim=1)
    c1, ch1, c2, ch2 = (over_units(rm[:, :, i]) for i in range(4))
    c3, c4 = over_units(f1), over_units(f2)
    own = torch.zeros_like(c1)
    for g in range(G):
        own[g, urc[g][vr[g]] // 8] = True
    none = torch.zeros_like(c1)
    if plan.tile_rows >= B:
        sets = (c1 | c2 | c3, c2 | c3 | ch1, none, c3 | ch2, none, c4)
    else:
        sets = (c1 | own, ch1, c2 | own, ch2, c3, c4)
    lmax = (max(R, FC) // 8 + 1) & ~1
    lens = torch.zeros(G, 8, dtype=torch.int32)
    lists = torch.zeros(G, len(SPARSE_LISTS), lmax, dtype=torch.int32)
    for li, cs in enumerate(sets):
        if li == 0:
            cs = cs.clone()
            cs[~cs.any(dim=1), 0] = True
        for g in range(G):
            idx = torch.nonzero(cs[g]).flatten()
            lens[g, li] = len(idx)
            lists[g, li, :len(idx)] = idx.to(torch.int32)
    pairs = lists.reshape(G, -1, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 16)
    nw_r, nw_f = -(-(R // 8) // 32), -(-(FC // 8) // 32)
    f1_at = UR * 12 * nw_r
    acting = (vr.any(dim=1) | vf.any(dim=1)).to(torch.bool)
    act = _mask_words(acting[None])[0]
    head = torch.zeros(SPARSE_HEAD, dtype=torch.int32)
    head[:9] = torch.tensor([nw_r, nw_f, lmax, f1_at, f1_at + UF * nw_r,
                             words.shape[1],
                             words.shape[1] + 8 + packed.shape[1], R, FC])
    table = torch.cat([head.expand(G, SPARSE_HEAD), words, lens, packed,
                       act.expand(G, act.shape[0])], dim=1)
    assert table.shape[1] == plan.sparse_words
    return table


def gather_streams(streams, plan: ResidentPlan):
    """B10's five streams (i, gi1, gi2, f1, f2: (T, B, width), as
    ``cuda_gen2.v2_streams`` returns them) gathered into the plan's unit
    order, float32 (T, G, slice_floats): block g's slice of step t is gi2
    (UR, 3, B), f1 (UF, B), f2 (UF, B), gi1 (UR, 3, B), i (UR, B), zero
    for padding slots and past the end. One pass over the streams before
    the launch, so each block copies its step's slice in one piece."""
    s_i, s_g1, s_g2, s_f1, s_f2 = streams
    T, B, _ = s_i.shape
    dev = s_i.device
    G = plan.G

    def part(s, n_gates, units):
        u = torch.tensor(units, device=dev)
        idx = u.clamp(min=0).flatten()
        width = s.shape[-1] // n_gates
        x = s.reshape(T, B, n_gates, width)[..., idx].float()
        x = x.reshape(T, B, n_gates, G, -1).permute(0, 3, 4, 2, 1)
        x = x * (u >= 0).to(x.dtype)[None, :, :, None, None]
        return x.reshape(T, G, -1)
    parts = [part(s_g2, 3, plan.units_r), part(s_f1, 1, plan.units_fc),
             part(s_f2, 1, plan.units_fc), part(s_g1, 3, plan.units_r),
             part(s_i, 1, plan.units_r)]
    pad = plan.slice_floats - sum(x.shape[-1] for x in parts)
    parts.append(torch.zeros(T, G, pad, dtype=torch.float32, device=dev))
    return torch.cat(parts, dim=2).contiguous()


def loop_body(core, sparse_packed=None, legacy: bool = False) -> str:
    """The kernel body a CUDA call runs on: "resident"
    (csrc/sample_loop_resident.cu) for every call, dense or with a
    non-empty ``sparse_packed`` (B9's arm); "fused"
    (csrc/sample_loop_fused.cu) only for the private ``legacy`` yardstick.
    A stale pack raises first."""
    _active_pack(core, sparse_packed)
    return "fused" if legacy else "resident"


class _ResArgs(ctypes.Structure):
    """``ResArgs`` of csrc/sample_loop_resident.cu, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("frames", "phi", "cond", "noise")]
                + [(f, ctypes.c_void_p) for f in _WEIGHT_FIELDS]
                + [(f, ctypes.c_void_p) for f in
                   ("h1_0", "h2_0", "x_0", "snap_h1", "snap_h2", "snap_x",
                    "out", "work", "units_r", "units_fc", "prof", "rows",
                    "wxw1", "wxw2", "streams", "sparse")]
                + [(f, ctypes.c_int64) for f in
                   ("B", "R", "FC", "A", "n_mels", "NC", "K", "hop",
                    "fold_chunks", "aux_tap", "T", "snapshot_at", "mol",
                    "seed", "bf16", "G", "UR", "UF", "TR", "w3_resident",
                    "exclusive", "smem_bytes", "row_bytes", "PBV", "SW")]
                + [("off", ctypes.c_int64 * len(RESIDENT_REGIONS))])


def _resident_lib():
    lib = _build.load("sample_loop_resident")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_resident_fused, lib.wr_resident_fused_state,
                   lib.wr_resident_materialized,
                   lib.wr_resident_fused_sparse,
                   lib.wr_resident_materialized_sparse, lib.wr_resident_v2,
                   lib.wr_resident_profile):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wr_resident_work_floats.argtypes = [ctypes.c_int64] * 5
        lib.wr_resident_work_floats.restype = ctypes.c_int64
        lib._typed = True
    return lib


_unit_tables: dict = {}


def _resident_launch(entry: str, w, dev, compute_dtype, B: int, K: int,
                     prof=None, pack=None, streams=None, **fields):
    """One launch of the resident body: its plan for this shape and card,
    the unit tables on ``dev`` (made once per plan), a zeroed workspace;
    B9's table for ``pack`` (made once per pack and plan), B10's
    ``streams`` gathered into the plan's order; ``fields`` fill the rest
    of ResArgs."""
    R, FC, A, NC = fields["R"], fields["FC"], fields["A"], fields["NC"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = resident_plan(R, FC, NC, A, fields["n_mels"], B, sms,
                         compute_dtype, K, sparse=pack is not None,
                         v2=streams is not None)
    # the ownership depends on the row count where the sampling blocks own
    # no unit
    key = (R, FC, sms, B if plan.exclusive else 0, dev)
    if key not in _unit_tables:
        _unit_tables[key] = tuple(
            torch.tensor(u, dtype=torch.int32, device=dev)
            for u in (plan.units_r, plan.units_fc))
    ur, uf = _unit_tables[key]
    if prof is not None and plan.rows_global:
        raise ValueError(f"the profiling instantiation keeps the per-row "
                         f"regions in shared memory: {B} rows need them in "
                         "device memory")
    for k in ("wi1", "wh1", "wi2x", "wh2", "w1x", "w2x", "w3"):
        if w[k].data_ptr() % 16:
            raise ValueError(f"{k} is not 16-byte aligned for the bulk copy")
    table = gathered = None
    if pack is not None:
        tkey = (sms, B, compute_dtype, K, dev)
        if tkey not in pack._tables:
            pack._tables[tkey] = resident_sparse_table(plan, pack, R, FC,
                                                       B).to(dev)
        table = pack._tables[tkey]
    if pack is not None and fields["T"] >= 1 << 29:
        raise ValueError(f"the sparse arm tags steps in 29 bits: T "
                         f"{fields['T']} is too long for one launch")
    if streams is not None:
        gathered = gather_streams(streams, plan)
    lib = _resident_lib()
    work = torch.zeros(lib.wr_resident_work_floats(B, R, FC, K, plan.G),
                       dtype=torch.float32, device=dev)
    rows = (torch.zeros(plan.G * plan.row_bytes // 4, dtype=torch.float32,
                        device=dev) if plan.rows_global else None)
    args = _ResArgs(
        work=work.data_ptr(), units_r=ur.data_ptr(), units_fc=uf.data_ptr(),
        prof=_ptr(prof), rows=_ptr(rows), sparse=_ptr(table),
        streams=_ptr(gathered), B=B, K=K,
        bf16=int(compute_dtype == torch.bfloat16),
        G=plan.G, UR=plan.UR, UF=plan.UF, TR=plan.tile_rows,
        w3_resident=int(plan.w3_resident), exclusive=int(plan.exclusive),
        smem_bytes=plan.smem_bytes, row_bytes=plan.row_bytes,
        PBV=plan.slice_floats, SW=plan.sparse_words,
        off=(ctypes.c_int64 * len(RESIDENT_REGIONS))(
            *(plan.offsets[n] for n in RESIDENT_REGIONS)),
        **{k: w[k].data_ptr() for k in _WEIGHT_FIELDS}, **fields)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(ctypes.byref(args),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"resident sample-loop kernel ({entry}) launch "
                           f"failed: CUDA error {err}")


def _check_kernel_call(core, mode: str, compute_dtype, dev):
    """The checks both kernels share; returns the prepared weights."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute_dtype must be bfloat16 or float32, got "
                        f"{compute_dtype}")
    if mode not in ("MOL", "RAW"):
        raise ValueError(f"unknown mode {mode!r}")
    R, FC, A, NC, n_mels = _dims(core)
    if R % 8 or FC % 8:
        raise ValueError("the kernel needs rnn_dims and fc_dims divisible "
                         "by 8")
    if mode == "MOL" and NC // 3 > 32:
        raise ValueError("the kernel samples at most 32 mixtures")
    w = _build.prepared("sample_loop_fused", core, compute_dtype,
                        lambda: kernel_weights(core, compute_dtype))
    for k in _WEIGHT_FIELDS:
        want = torch.float32 if k in _F32_FIELDS else compute_dtype
        _build.check_operand(w[k], k, want, w[k].shape, dev)
    return w


def _launch(entry: str, args: _LoopArgs, dev, what: str):
    with torch.cuda.device(dev):
        err = getattr(_lib(), entry)(ctypes.byref(args),
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def generate_fused(core, frames, phi, hop: int, aux_tap: int,
                   fold_chunks: int, mode: str, noise=None, seed: int = 0,
                   compute_dtype=torch.bfloat16, sparse_packed=None,
                   _legacy: bool = False):
    """Sample loop with in-kernel conditioning upsample.

    core: the vocoder's weights by reference state-dict name;
    frames (fold_chunks + K - 1, num_folds, n_mels + 4A) float32 from
    ``polyphase.build_folded_frames``; phi (K, hop) from ``phi_table``.
    noise: injected uniforms (see the module docstring) or None for the
    counter hash keyed by ``seed``.
    Returns samples (num_folds, fold_chunks*hop) float32.

    CPU tensors run the plain version (float32 throughout); CUDA tensors
    launch the kernel with matrices in ``compute_dtype``, split and cast
    once per weight set (``_build.prepared``). ``sparse_packed``
    (``pack_sparse`` of these weights): the kernel's sparse arm (B9), which
    multiplies only the packed matrices' live blocks; an empty pack serves
    dense. Both run on the resident body (``loop_body``); ``_legacy`` runs
    them on the original body instead, as the yardstick."""
    if frames.device.type == "cpu":
        return generate_fused_ref(core, frames, phi, hop, aux_tap,
                                  fold_chunks, mode, noise, seed,
                                  sparse_packed)
    pack = _active_pack(core, sparse_packed)
    resident = loop_body(core, sparse_packed, _legacy) == "resident"
    out = _fused_launch(core, frames, phi, hop, aux_tap, fold_chunks, mode,
                        noise, seed, compute_dtype, pack, None, resident)
    _count(generate_fused, resident, pack is not None)
    return out


def _count(fn, resident: bool, sparse: bool):
    """One launch of ``fn``'s kernel: its total, and the arm's own count."""
    fn.launches += 1
    arm = ("sparse_launches" if sparse else "resident_launches") if resident \
        else ("legacy_sparse_launches" if sparse else "legacy_launches")
    setattr(fn, arm, getattr(fn, arm) + 1)


# launches of B1 on either body; of the resident body's dense arm and its
# sparse arm (B9); of the original body's dense and sparse arms (the
# private yardstick)
generate_fused.launches = 0
generate_fused.resident_launches = 0
generate_fused.sparse_launches = 0
generate_fused.legacy_launches = 0
generate_fused.legacy_sparse_launches = 0


def generate_fused_with_state(core, frames, phi, hop: int, aux_tap: int,
                              fold_chunks: int, mode: str, noise=None,
                              seed: int = 0, init_state=None,
                              state_snapshot_at=None,
                              compute_dtype=torch.bfloat16,
                              _legacy: bool = False):
    """B4b: ``generate_fused`` resuming from and snapshotting the RNN state
    (``generate_pallas_fused_with_state``'s contract, with
    ``generate_materialized``'s convention for the snapshot).

    init_state: (h1 (B, R), h2 (B, R), x (B,)) to resume from, zeros when
    None; state_snapshot_at: the step s in [0, T] whose entering state is
    returned, the final state when None. A launch covers whole hop chunks,
    so two chained launches split at a chunk boundary c1 (the second takes
    ``frames[c1:]`` and the noise from step c1*hop on) equal one launch.
    Returns (samples (B, fold_chunks*hop), (h1, h2, x)).

    CPU tensors run the plain version (float32 throughout); CUDA tensors
    launch B1's state arm with matrices in ``compute_dtype``. Dense only:
    the exact-seam passes run a pruned model's masked weights dense, as
    the JAX package does. The resident body runs it; ``_legacy`` the PR
    1-7 body's state arm."""
    if frames.device.type == "cpu":
        return generate_fused_with_state_ref(
            core, frames, phi, hop, aux_tap, fold_chunks, mode, noise, seed,
            init_state, state_snapshot_at)
    state = (init_state, state_snapshot_at)
    out = _fused_launch(core, frames, phi, hop, aux_tap, fold_chunks, mode,
                        noise, seed, compute_dtype, None, state, not _legacy)
    _count(generate_fused_with_state, not _legacy, False)
    return out


# launches of B4b on either body; on the resident body; on the original body
generate_fused_with_state.launches = 0
generate_fused_with_state.resident_launches = 0
generate_fused_with_state.legacy_launches = 0


def _state_operands(init_state, state_snapshot_at, B: int, R: int, T: int,
                    dev):
    """The state arm's operands: (h1_0, h2_0, x_0) float32 or Nones, the
    snapshot buffers (h1, h2, x) and the snapshot step in [0, T]."""
    s = T if state_snapshot_at is None else int(state_snapshot_at)
    if not 0 <= s <= T:
        raise ValueError(f"state_snapshot_at {s} outside [0, {T}]")
    state = [None, None, None]
    if init_state is not None:
        for i, (v, name, shape) in enumerate(zip(
                init_state, ("h1", "h2", "x"), ((B, R), (B, R), (B,)))):
            state[i] = v.to(torch.float32).contiguous()
            _build.check_operand(state[i], name, torch.float32, shape, dev)
    snap = (torch.empty(B, R, dtype=torch.float32, device=dev),
            torch.empty(B, R, dtype=torch.float32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev))
    return state, snap, s


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fused_launch(core, frames, phi, hop, aux_tap, fold_chunks, mode, noise,
                  seed, compute_dtype, pack, state, resident, prof=None):
    """One launch of the fused loop on CUDA tensors: B1 (``state`` None),
    or its state arm B4b (``state`` = (init_state, state_snapshot_at)),
    which also returns the snapshot; on the resident body or (``resident``
    False) the original body. ``prof``: the resident body's profiling
    instantiation, its cycles written there."""
    if frames.device.type != "cuda":
        raise ValueError(f"no fused sample loop for {frames.device}")
    dev = frames.device
    w = _check_kernel_call(core, mode, compute_dtype, dev)
    R, FC, A, NC, n_mels = _dims(core)
    K = phi.shape[0]
    nf_loc, B, C = frames.shape
    T = fold_chunks * hop
    mol = mode == "MOL"
    _build.check_operand(frames, "frames", torch.float32,
                         (fold_chunks + K - 1, B, n_mels + 4 * A), dev)
    _build.check_operand(phi, "phi", torch.float32, (K, hop), dev)
    if not 0 <= aux_tap < K:
        raise ValueError(f"aux_tap {aux_tap} outside the {K} frame taps")
    if fold_chunks < 1:
        raise ValueError("the sample loop needs at least one hop chunk")
    u = None
    if noise is not None:
        u = noise_stream(noise, T, mode)
        _build.check_operand(u, "noise", torch.float32,
                             (T, B, NC // 3 + 1 if mol else NC), dev)
    st, snap, s = ([None] * 3, (None,) * 3, T) if state is None else \
        _state_operands(*state, B, R, T, dev)
    out = torch.empty(B, T, dtype=torch.float32, device=dev)
    if resident:
        if K > RESIDENT_MAX_TAPS:
            raise ValueError(f"the resident sample loop preloads at most "
                             f"{RESIDENT_MAX_TAPS} mel taps, got {K}")
        entry = ("wr_resident_profile" if prof is not None
                 else "wr_resident_fused_sparse" if pack is not None
                 else "wr_resident_fused" if state is None
                 else "wr_resident_fused_state")
        _resident_launch(
            entry, w, dev, compute_dtype, B, K, prof, pack,
            frames=frames.data_ptr(), phi=phi.data_ptr(), noise=_ptr(u),
            h1_0=_ptr(st[0]), h2_0=_ptr(st[1]), x_0=_ptr(st[2]),
            snap_h1=_ptr(snap[0]), snap_h2=_ptr(snap[1]),
            snap_x=_ptr(snap[2]), out=out.data_ptr(), R=R, FC=FC, A=A,
            n_mels=n_mels, NC=NC, hop=hop, fold_chunks=fold_chunks,
            aux_tap=aux_tap, T=T, snapshot_at=s, mol=int(mol),
            seed=seed & _M32)
        return out if state is None else (out, snap)
    work = torch.zeros(_lib().wr_sample_loop_work_floats(B, R, FC, K, 1),
                       dtype=torch.float32, device=dev)
    args = _LoopArgs(
        frames=frames.data_ptr(), phi=phi.data_ptr(), noise=_ptr(u),
        h1_0=_ptr(st[0]), h2_0=_ptr(st[1]), x_0=_ptr(st[2]),
        snap_h1=_ptr(snap[0]), snap_h2=_ptr(snap[1]), snap_x=_ptr(snap[2]),
        out=out.data_ptr(), work=work.data_ptr(),
        B=B, R=R, FC=FC, A=A, n_mels=n_mels, NC=NC, K=K, hop=hop,
        fold_chunks=fold_chunks, aux_tap=aux_tap, T=T, span=hop,
        snapshot_at=s, mol=int(mol), seed=seed & _M32,
        bf16=int(compute_dtype == torch.bfloat16),
        sp=_sparse_args(pack, compute_dtype, dev),
        **{k: w[k].data_ptr() for k in _WEIGHT_FIELDS})
    if state is None:
        _launch("wr_sample_loop_fused", args, dev, "fused sample-loop")
        return out
    _launch("wr_sample_loop_fused_state", args, dev,
            "fused sample-loop (state)")
    return out, snap


# conditioning rows (steps x batch rows) the materialized kernel projects
# per span; its workspace holds one span
SPAN_ROWS = 256


def generate_materialized(core, mels_up, aux, mode: str, noise=None,
                          seed: int = 0, init_state=None,
                          state_snapshot_at=None,
                          compute_dtype=torch.bfloat16, sparse_packed=None,
                          _legacy: bool = False):
    """The materialized sample loop with state I/O,
    ``generate_materialized_ref``'s contract.

    mels_up (B, T, n_mels), aux (B, T, 4A) float32; noise: injected
    uniforms (T, B, ...) or None for the counter hash keyed by ``seed``;
    init_state: (h1, h2, x) to resume from, zeros when None;
    state_snapshot_at: the step s in [0, T] whose entering state is
    returned, the final state when None. One launch of T steps equals two
    chained launches of T1 and T - T1 steps under the same noise.

    CPU tensors run the plain version (float32 throughout); CUDA tensors
    launch the kernel with matrices in ``compute_dtype``;
    ``sparse_packed`` and ``_legacy`` as in ``generate_fused``."""
    if mels_up.device.type == "cpu":
        return generate_materialized_ref(core, mels_up, aux, mode, noise,
                                         seed, init_state, state_snapshot_at,
                                         sparse_packed)
    pack = _active_pack(core, sparse_packed)
    resident = loop_body(core, sparse_packed, _legacy) == "resident"
    out = _materialized_launch(core, mels_up, aux, mode, noise, seed,
                               init_state, state_snapshot_at, compute_dtype,
                               pack, resident)
    _count(generate_materialized, resident, pack is not None)
    return out


def _materialized_launch(core, mels_up, aux, mode, noise, seed, init_state,
                         state_snapshot_at, compute_dtype, pack, resident,
                         prof=None):
    """One launch of the materialized loop on CUDA tensors, on the resident
    body or (``resident`` False) the original body; returns (samples,
    snapshot). ``prof``: the resident body's profiling instantiation, its
    cycles written there."""
    if mels_up.device.type != "cuda":
        raise ValueError(f"no materialized sample loop for {mels_up.device}")
    dev = mels_up.device
    w = _check_kernel_call(core, mode, compute_dtype, dev)
    R, FC, A, NC, n_mels = _dims(core)
    B, T, _ = mels_up.shape
    mol = mode == "MOL"
    if T < 1:
        raise ValueError("the sample loop needs at least one step")
    if tuple(mels_up.shape) != (B, T, n_mels) or tuple(aux.shape) != (
            B, T, 4 * A):
        raise ValueError(f"mels_up {tuple(mels_up.shape)} and aux "
                         f"{tuple(aux.shape)} do not match the weights' "
                         f"(B, T, {n_mels}) and (B, T, {4 * A})")
    cond = torch.cat([mels_up, aux], dim=-1).transpose(0, 1).contiguous()
    _build.check_operand(cond, "cond", torch.float32,
                         (T, B, n_mels + 4 * A), dev)
    u = None
    if noise is not None:
        u = noise_stream(noise, T, mode)
        _build.check_operand(u, "noise", torch.float32,
                             (T, B, NC // 3 + 1 if mol else NC), dev)
    state, snap, s = _state_operands(init_state, state_snapshot_at, B, R, T,
                                     dev)
    out = torch.empty(B, T, dtype=torch.float32, device=dev)
    if resident:
        _resident_launch(
            "wr_resident_profile" if prof is not None
            else "wr_resident_materialized_sparse" if pack is not None
            else "wr_resident_materialized", w, dev, compute_dtype, B, 0,
            prof, pack,
            cond=cond.data_ptr(), noise=_ptr(u), h1_0=_ptr(state[0]),
            h2_0=_ptr(state[1]), x_0=_ptr(state[2]),
            snap_h1=snap[0].data_ptr(), snap_h2=snap[1].data_ptr(),
            snap_x=snap[2].data_ptr(), out=out.data_ptr(), R=R, FC=FC, A=A,
            n_mels=n_mels, NC=NC, hop=1, T=T, snapshot_at=s, mol=int(mol),
            seed=seed & _M32)
        return out, snap
    span = max(1, min(T, SPAN_ROWS // B))
    work = torch.zeros(_lib().wr_sample_loop_work_floats(B, R, FC, 0, span),
                       dtype=torch.float32, device=dev)
    args = _LoopArgs(
        cond=cond.data_ptr(), noise=_ptr(u), h1_0=_ptr(state[0]),
        h2_0=_ptr(state[1]), x_0=_ptr(state[2]), snap_h1=snap[0].data_ptr(),
        snap_h2=snap[1].data_ptr(), snap_x=snap[2].data_ptr(),
        out=out.data_ptr(), work=work.data_ptr(),
        B=B, R=R, FC=FC, A=A, n_mels=n_mels, NC=NC, K=0, hop=1,
        fold_chunks=0, aux_tap=0, T=T, span=span, snapshot_at=s,
        mol=int(mol), seed=seed & _M32,
        bf16=int(compute_dtype == torch.bfloat16),
        sp=_sparse_args(pack, compute_dtype, dev),
        **{k: w[k].data_ptr() for k in _WEIGHT_FIELDS})
    _launch("wr_sample_loop_materialized", args, dev,
            "materialized sample-loop")
    return out, snap


# as generate_fused's counts
generate_materialized.launches = 0
generate_materialized.resident_launches = 0
generate_materialized.sparse_launches = 0
generate_materialized.legacy_launches = 0
generate_materialized.legacy_sparse_launches = 0


def generate_fused_profiled(core, frames, phi, hop: int, aux_tap: int,
                            fold_chunks: int, mode: str, seed: int = 0,
                            sparse_packed=None):
    """B1 (or, with ``sparse_packed``, its sparse arm B9) on the resident
    body's profiling instantiation (bfloat16 matrices, the counter hash):
    its samples and the per-stage split of a
    step, clock64() cycles of block 0's thread 0 summed over the launch,
    by stage (prologue, gru1, gru2, fc1, fc2, sample) and kind (its first
    poll pass over the stage's tagged inputs, the wait for the rest and
    the block, its products and gate tails (stage 5: fc3), the draw
    (stage 5), the deferred work (the next step's hidden products, the
    next index's conditioning, the sampler's preload), the rest: B3's copy
    of the next step's rows, the sampler's store of v), with the step
    count. Not a serving
    path; its launches are not counted."""
    prof = _prof_buffer(frames.device)
    out = _fused_launch(core, frames, phi, hop, aux_tap, fold_chunks, mode,
                        None, seed, torch.bfloat16,
                        _active_pack(core, sparse_packed), None, True, prof)
    return (out,) + _prof_split(prof)


def generate_materialized_profiled(core, mels_up, aux, mode: str,
                                   seed: int = 0):
    """``generate_fused_profiled`` for B3: its samples and the per-stage
    split of a step on the resident body's profiling instantiation."""
    prof = _prof_buffer(mels_up.device)
    out = _materialized_launch(core, mels_up, aux, mode, None, seed, None,
                               None, torch.bfloat16, None, True, prof)[0]
    return (out,) + _prof_split(prof)


def _prof_buffer(device):
    return torch.zeros(len(_PROF_STAGES) * len(_PROF_KINDS) + 1,
                       dtype=torch.int64, device=device)


def _prof_split(prof):
    """(cycles by stage and kind, the step count) of a profiled launch."""
    cyc = prof.tolist()
    split = {st: {kd: cyc[i * len(_PROF_KINDS) + j]
                  for j, kd in enumerate(_PROF_KINDS)}
             for i, st in enumerate(_PROF_STAGES)}
    return split, cyc[-1]
