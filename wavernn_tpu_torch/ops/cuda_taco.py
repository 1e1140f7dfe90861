"""Tacotron free-running decode: the CUDA kernels' wrappers and their plain
PyTorch versions.

Both kernels run all ``steps // r`` decoder groups in one cooperative
launch, including the stop test, the state freeze and the replay of the
frozen group:

- B2, ``decode``: one utterance; port of
  ``wavernn_tpu/ops/pallas_taco.py::decode_pallas`` (``_make_kernel``).
- B8, ``decode_batch``: B utterances of right-padded text with a text mask
  and a stop and freeze per row; port of ``decode_pallas_batch``
  (``_make_batch_kernel``, B <= 8) and ``decode_pallas_stacked``
  (``_make_stacked_kernel``, B > 8).

Both launch the resident body ``csrc/taco_decode_resident.cu``
(``taco_dec_res``; B2 is its one-row instantiation) on a launch plan from
``decode_resident_plan``: one launch for any batch and text length. The
original body ``csrc/taco_decode.cu`` (``taco_decode``, ``taco_decode_batch``)
is the yardstick, reached only through the wrappers' private
``_legacy=True``, with its own counters (``legacy_launches``).

``decode_batch_ref`` is the plain version of both, one
``models.tacotron.decoder_step`` per group; ``decode_ref`` is its one-row
case. Each wrapper runs the plain version for CPU tensors and launches a
kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from typing import Dict, List, Tuple

from . import _build


def decode_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
               steps: int, n_mels: int, max_r: int, stop_threshold: float):
    """Plain free-running decode of one utterance: ``decode_batch_ref`` of
    one row. encoder_seq (1, T, E), encoder_seq_proj (1, T, D), text_mask
    (T,). Returns (mel (1, n_mels, steps), attn (1, steps // r, T),
    n_valid (1,) int32)."""
    return decode_batch_ref(dec, encoder_seq, encoder_seq_proj,
                            text_mask[None], r, steps, n_mels, max_r,
                            stop_threshold)


def decode_batch_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
                     steps: int, n_mels: int, max_r: int,
                     stop_threshold: float):
    """Plain free-running decode of B utterances of right-padded text.

    dec: decoder weights by state-dict name (``Tacotron.decoder_weights``);
    encoder_seq (B, T, E), encoder_seq_proj (B, T, D), text_mask (B, T): 1 on
    a row's text, 0 on its padding (the smooth attention's normalisation
    skips the padding). A group stops its row when all the row's values are
    below ``stop_threshold`` and g*r > 10; the row's state then stays
    frozen, so its later groups all emit the output of its first
    frozen-state step. Once every row has stopped, that group repeats.
    Returns (mel (B, n_mels, steps), attn (B, steps // r, T), n_valid (B,)
    int32: each row's groups up to and including its trigger)."""
    from ..models.tacotron import DecoderState, decoder_step, \
        init_decoder_state

    n_groups = steps // r
    B, T, _ = encoder_seq.shape
    dev = encoder_seq.device
    state = init_decoder_state(dec, B, T, n_mels, dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    n_valid = torch.zeros(B, dtype=torch.int32, device=dev)
    held = None
    mels_out, attn_out = [], []
    for g in range(n_groups):
        if held is None:
            mels, scores, new = decoder_step(
                dec, encoder_seq, encoder_seq_proj, state.prev_frame, state,
                r, n_mels, max_r, text_mask)
            if bool(stopped.all()):
                held = (mels, scores)   # every row's frozen output, for good
            n_valid += (~stopped).int()
            state = DecoderState(*(
                torch.where(stopped.reshape((-1,) + (1,) * (n.dim() - 1)),
                            o, n) for o, n in zip(state, new)))
            stopped = stopped | ((mels < stop_threshold).flatten(1).all(1)
                                 & (g * r > 10))
        else:
            mels, scores = held
        mels_out.append(mels)
        attn_out.append(scores)
    mel = torch.stack(mels_out, dim=2).reshape(B, n_mels, n_groups * r)
    return mel, torch.stack(attn_out, dim=1), n_valid


_FIELDS = ("w1p", "b1p", "w2p", "b2p", "awi", "abi", "awh", "abh", "wq", "qb",
           "conv", "lw", "v", "wr", "br", "l1wi", "l1wh", "l1b", "l2wi",
           "l2wh", "l2b", "wm")


def kernel_weights(dec, r: int, n_mels: int, max_r: int):
    """The kernels' float32 weight operands. mel_proj keeps the rows of the
    r frames, reordered frame-major (reference reshape (n_mels, max_r) then
    [:, :r], tacotron.py:267-268); the LSTM biases are summed; ``lwt`` is
    L's weight transposed (32, D), which the resident body reads in place
    of ``lw``."""
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    wm = dec["mel_proj.weight"].reshape(n_mels, max_r, L_)[:, :r]
    parts = {
        "w1p": dec["prenet.fc1.weight"], "b1p": dec["prenet.fc1.bias"],
        "w2p": dec["prenet.fc2.weight"], "b2p": dec["prenet.fc2.bias"],
        "awi": dec["attn_rnn.weight_ih"], "abi": dec["attn_rnn.bias_ih"],
        "awh": dec["attn_rnn.weight_hh"], "abh": dec["attn_rnn.bias_hh"],
        "wq": dec["attn_net.W.weight"],
        "qb": dec["attn_net.W.bias"] + dec["attn_net.L.bias"],
        "conv": dec["attn_net.conv.weight"], "lw": dec["attn_net.L.weight"],
        "v": dec["attn_net.v.weight"][0],
        "wr": dec["rnn_input.weight"], "br": dec["rnn_input.bias"],
        "l1wi": dec["res_rnn1.weight_ih"], "l1wh": dec["res_rnn1.weight_hh"],
        "l1b": dec["res_rnn1.bias_ih"] + dec["res_rnn1.bias_hh"],
        "l2wi": dec["res_rnn2.weight_ih"], "l2wh": dec["res_rnn2.weight_hh"],
        "l2b": dec["res_rnn2.bias_ih"] + dec["res_rnn2.bias_hh"],
        "wm": wm.transpose(0, 1).reshape(r * n_mels, L_),
        "lwt": dec["attn_net.L.weight"].t(),
    }
    return {k: v.detach().to(torch.float32).contiguous()
            for k, v in parts.items()}


def _args_struct(name: str, ints):
    return type(name, (ctypes.Structure,), {"_fields_": (
        [("enc", ctypes.c_void_p), ("encp", ctypes.c_void_p),
         ("mask", ctypes.c_void_p)]
        + [(f, ctypes.c_void_p) for f in _FIELDS]
        + [("mel_out", ctypes.c_void_p), ("att_out", ctypes.c_void_p),
           ("n_valid", ctypes.c_void_p), ("work", ctypes.c_void_p)]
        + [(f, ctypes.c_int64) for f in ints]
        + [("stop_threshold", ctypes.c_double)])})


# DecodeArgs (B2) and BatchArgs (B8) of csrc/taco_decode.cu, field for field
_DecodeArgs = _args_struct("_DecodeArgs", ("T", "E", "D", "P1", "P2", "L",
                                           "n_mels", "r", "n_groups"))
_BatchArgs = _args_struct("_BatchArgs", ("B", "T", "E", "D", "P1", "P2", "L",
                                         "n_mels", "r", "n_groups"))


def _lib():
    lib = _build.load("taco_decode")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_taco_decode, lib.wr_taco_decode_batch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.wr_taco_decode_work_floats,
                   lib.wr_taco_decode_batch_work_floats,
                   lib.wr_taco_decode_batch_shared_bytes):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib._typed = True
    return lib


def _check_widths(dec, E: int, r: int, n_mels: int, max_r: int):
    """The decoder widths both kernels take: (D, P1, P2, L)."""
    D = dec["attn_rnn.weight_hh"].shape[1]
    P1 = dec["prenet.fc1.weight"].shape[0]
    P2 = dec["prenet.fc2.weight"].shape[0]
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    if any(n % 4 for n in (E, D, P1, P2, L_, n_mels)) or D % 32:
        raise ValueError("the decode kernel needs every width divisible by "
                         "4 and decoder_dims by 32")
    if not 1 <= r <= max_r:
        raise ValueError(f"r={r} outside [1, max_r={max_r}]")
    return D, P1, P2, L_


def _prepare(dec, encoder_seq, encoder_seq_proj, text_mask, r, n_mels,
             max_r):
    """Checked operands of a CUDA launch: (dims, enc, encp, mask, weights)."""
    dev = encoder_seq.device
    B, T, E = encoder_seq.shape
    D, P1, P2, L_ = _check_widths(dec, E, r, n_mels, max_r)
    f32 = torch.float32
    enc = encoder_seq.contiguous()
    encp = encoder_seq_proj.contiguous()
    mask = text_mask.to(f32).contiguous()
    _build.check_operand(enc, "encoder_seq", f32, (B, T, E), dev)
    _build.check_operand(encp, "encoder_seq_proj", f32, (B, T, D), dev)
    _build.check_operand(mask, "text_mask", f32, (B, T), dev)
    w = _build.prepared("taco_decode", dec, (r, n_mels, max_r),
                        lambda: kernel_weights(dec, r, n_mels, max_r))
    for k in _FIELDS + ("lwt",):
        _build.check_operand(w[k], k, f32, w[k].shape, dev)
    dims = dict(B=B, T=T, E=E, D=D, P1=P1, P2=P2, L=L_, n_mels=n_mels, r=r)
    return dims, enc, encp, mask, w


def decode(dec, encoder_seq, encoder_seq_proj, text_mask, r: int, steps: int,
           n_mels: int, max_r: int, stop_threshold: float,
           _legacy: bool = False, _profile=None):
    """Free-running decode of one utterance, ``decode_ref``'s contract.

    CPU tensors run the plain version; CUDA tensors launch the resident
    body's one-row instantiation (``decode.launches``) on operands prepared
    once per weight set and r (``_build.prepared``). ``_legacy=True`` (for
    comparisons) launches the original body's ``taco_decode`` instead
    (``decode.legacy_launches``); ``_profile`` (a zeroed CUDA int64 tensor
    of ``len(RES_PROF) + len(RES_SUBPROF)`` entries) takes block 0's
    cycles, per stage and inside the stages, summed over the groups."""
    if encoder_seq.device.type == "cpu":
        return decode_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r,
                          steps, n_mels, max_r, stop_threshold)
    if encoder_seq.device.type != "cuda":
        raise ValueError(f"no decode kernel for {encoder_seq.device}")
    if not _legacy:
        out = _resident(dec, encoder_seq, encoder_seq_proj, text_mask[None],
                        r, steps, n_mels, max_r, stop_threshold, _profile)
        decode.launches += 1
        return out
    dev = encoder_seq.device
    _, T, E = encoder_seq.shape
    dims, enc, encp, _, w = _prepare(dec, encoder_seq, encoder_seq_proj,
                                     text_mask[None], r, n_mels, max_r)
    n_groups = steps // r
    F = r * n_mels
    mel_out = torch.empty(n_groups, F, dtype=torch.float32, device=dev)
    att_out = torch.empty(n_groups, T, dtype=torch.float32, device=dev)
    n_valid = torch.empty(1, dtype=torch.int32, device=dev)
    args = _DecodeArgs(
        enc=enc.data_ptr(), encp=encp.data_ptr(), mask=text_mask.data_ptr(),
        mel_out=mel_out.data_ptr(), att_out=att_out.data_ptr(),
        n_valid=n_valid.data_ptr(), T=T, E=E, D=dims["D"], P1=dims["P1"],
        P2=dims["P2"], L=dims["L"], n_mels=n_mels, r=r, n_groups=n_groups,
        stop_threshold=float(stop_threshold),
        **{k: w[k].data_ptr() for k in _FIELDS})
    lib = _lib()
    work = torch.zeros(lib.wr_taco_decode_work_floats(ctypes.byref(args)),
                       dtype=torch.float32, device=dev)
    args.work = work.data_ptr()
    _launch(lib.wr_taco_decode, args, dev, "decode")
    decode.legacy_launches += 1
    mel = mel_out.reshape(n_groups, r, n_mels).permute(2, 0, 1)
    mel = mel.reshape(1, n_mels, n_groups * r)
    return mel, att_out[None], n_valid


decode.launches = 0
decode.legacy_launches = 0


def _launch(fn, args, dev, what: str, *extra):
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), *extra,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# the most shared memory the original batched kernel's launch may ask for:
# a batch whose rows' (T_text + decoder_dims) planes would need more is
# split into launches that fit (the H100's 227 KB a block, less headroom)
SHARED_LIMIT = 200 * 1024


def decode_batch(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
                 steps: int, n_mels: int, max_r: int, stop_threshold: float,
                 _legacy: bool = False, _profile=None):
    """Free-running decode of B utterances, ``decode_batch_ref``'s contract.

    CPU tensors run the plain version; CUDA tensors launch the resident
    body once for the whole batch, any B and T_text (its plan puts what
    does not fit a block's shared memory in device memory;
    ``decode_batch.launches``). ``_legacy=True`` (for comparisons) runs the
    original body's ``taco_decode_batch`` (``decode_batch.legacy_launches``):
    its shared memory grows with B * T_text, so a batch past
    ``SHARED_LIMIT`` runs there as consecutive launches of as many rows as
    fit, and a text too long for one row raises. ``_profile`` as
    ``decode``'s."""
    if encoder_seq.device.type == "cpu":
        return decode_batch_ref(dec, encoder_seq, encoder_seq_proj,
                                text_mask, r, steps, n_mels, max_r,
                                stop_threshold)
    if encoder_seq.device.type != "cuda":
        raise ValueError(f"no decode kernel for {encoder_seq.device}")
    if not _legacy:
        out = _resident(dec, encoder_seq, encoder_seq_proj, text_mask, r,
                        steps, n_mels, max_r, stop_threshold, _profile)
        decode_batch.launches += 1
        return out
    dev = encoder_seq.device
    B, T, E = encoder_seq.shape
    dims, enc, encp, mask, w = _prepare(dec, encoder_seq, encoder_seq_proj,
                                        text_mask, r, n_mels, max_r)
    n_groups = steps // r
    f32 = torch.float32
    rows = batch_rows(B, T, dims["D"])
    if rows < 1:
        raise ValueError(f"T_text {T} needs more shared memory than one "
                         "launch of the original body may ask for")
    F = r * n_mels
    mel_out = torch.empty(B, n_groups, F, dtype=f32, device=dev)
    att_out = torch.empty(B, n_groups, T, dtype=f32, device=dev)
    n_valid = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib()
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        args = _BatchArgs(
            enc=enc[b0].data_ptr(), encp=encp[b0].data_ptr(),
            mask=mask[b0].data_ptr(), mel_out=mel_out[b0].data_ptr(),
            att_out=att_out[b0].data_ptr(), n_valid=n_valid[b0:].data_ptr(),
            B=b1 - b0, T=T, E=E, D=dims["D"], P1=dims["P1"], P2=dims["P2"],
            L=dims["L"], n_mels=n_mels, r=r, n_groups=n_groups,
            stop_threshold=float(stop_threshold),
            **{k: w[k].data_ptr() for k in _FIELDS})
        work = torch.zeros(lib.wr_taco_decode_batch_work_floats(
            ctypes.byref(args)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        _launch(lib.wr_taco_decode_batch, args, dev, "batched decode")
        decode_batch.legacy_launches += 1
    mel = mel_out.reshape(B, n_groups, r, n_mels).permute(0, 3, 1, 2)
    return mel.reshape(B, n_mels, n_groups * r), att_out, n_valid


decode_batch.launches = 0
decode_batch.legacy_launches = 0


def batch_rows(B: int, T: int, D: int) -> int:
    """The most rows of a batch one launch of the original batched kernel
    takes (its shared memory, ``batch_shared_bytes`` in the source, within
    ``SHARED_LIMIT``)."""
    fixed = 4 * (32 * 2 * 31 + 32 * D + D)
    per_row = 4 * (D + 2 * T + 1) + 4 * 5
    return min(B, (SHARED_LIMIT - fixed) // per_row)


# ---------------------------------------------------------------------------
# the resident body (csrc/taco_decode_resident.cu)
# ---------------------------------------------------------------------------

H100_SMEM = 232448   # shared memory a block can opt into on the H100
THREADS = 256
WARPS = THREADS // 32
TC = 16              # the most text positions of an attention item
WINP = 48            # an item's window of the location conv's input, padded
LOC_CH = 32          # location conv channels (tacotron.py:176)
CONV_K = 31          # its taps
# the attention scratch: windows of the cumulative and the attention, the
# warps' partial energies, the energies, 16 spare, the item's conv outputs
ATT_FLOATS = 2 * WINP + WARPS * TC + TC + 16 + TC * LOC_CH
# the head of the shared memory: the weights' mbarrier, the workspace views
HEAD_FLOATS = 4 + 64
# the attention items' sizes below 16 the plan tries, smallest first
ITEM_SIZES = (4, 8)
# the matrix stages' weight groups, in the order of their DecPlan fields:
# (name, kernel operand, units, gates, columns) for a dims dict
WEIGHT_GROUPS = ("fc1", "fc2", "awi", "awh", "wq", "wr", "l1wi", "l1wh",
                 "l2wi", "l2wh", "wm")
# which group becomes resident first where a block's shared memory cannot
# hold them all: the chain's weights (the LSTMs' input halves first), then
# the off-chain halves', then the items' location features
RES_ORDER = ("l1wi", "l2wi", "wr", "awi", "wm", "wq", "fc2", "fc1", "l1wh",
             "l2wh", "awh", "e")
DEC_FIELDS = (("nblk", "smem_bytes", "rt", "rows", "kc", "off_x", "off_conv",
               "off_v", "off_att", "off_rows", "ti", "nc", "ipb", "e_smem",
               "off_e")
              + tuple(f"{k}_{g}" for g in WEIGHT_GROUPS
                      for k in ("res", "off")))
_DecPlan = type("_DecPlan", (ctypes.Structure,), {
    "_fields_": [(f, ctypes.c_int64) for f in DEC_FIELDS]})
# the profiling instantiation's labels, one per DProf enumerator
RES_PROF = tuple(f"{s}{x}" for s in ("fc1", "fc2", "gru", "query", "items",
                                     "rnn_input", "lstm1", "lstm2", "mel")
                 for x in ("", "_slack", "_wait")) + ("stop", "prologue")
# and the split inside the stages and the items (SProf), from RES_PROF's end
RES_SUBPROF = ("stage_first_copies", "stage_chunk_waits", "stage_products",
               "stage_epilogues", "loc_loads", "loc_conv", "loc_L",
               "items_tanh", "items_energy_sums", "items_partials",
               "items_arrival", "items_reduction")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(n: int) -> int:
    return _cdiv(n, 4) * 4


def weight_groups(dims) -> Dict[str, Tuple[int, int, int]]:
    """Each matrix stage's weight group: name -> (units, gates, columns).
    fc1 / fc2 the prenet, awi / awh the attention GRUCell's input ([ctx |
    p]) and hidden products, wq the query, wr rnn_input, l1wi ... l2wh the
    LSTMs' input and hidden products, wm mel_proj's r frames."""
    D, E, L = dims["D"], dims["E"], dims["L"]
    P1, P2, NM = dims["P1"], dims["P2"], dims["n_mels"]
    F = dims["r"] * NM
    return {"fc1": (P1, 1, NM), "fc2": (P2, 1, P1), "awi": (D, 3, E + P2),
            "awh": (D, 3, D), "wq": (D, 1, D), "wr": (L, 1, E + D),
            "l1wi": (L, 4, L), "l1wh": (L, 4, L), "l2wi": (L, 4, L),
            "l2wh": (L, 4, L), "wm": (F, 1, L)}


def decode_resident_plan(dims, sms: int = 132,
                         smem_bytes: int = H100_SMEM) -> Dict[str, int]:
    """The resident decode body's launch plan (``DEC_FIELDS``; offsets in
    floats into the dynamic shared memory, whose first ``HEAD_FLOATS`` hold
    the weights' mbarrier and the workspace views) for ``dims`` (B, T, E, D, P1, P2, L, n_mels, r) on
    ``sms`` SMs with ``smem_bytes`` of shared memory a block.

    One block per SM; unit j of a stage on block j mod grid; attention item
    i (``ti`` text positions of one row, the fewest of 4, 8 and 16 that
    leave no block more than one item where that can be, else 16) on block
    i mod grid. A warp's tile is
    ``rt`` rows: 1 for one row (read in place, nothing staged), else 8, a
    pass of ``rows`` rows (up to 32) staged ``kc`` columns at a time into
    two buffers. Always in shared memory: the location conv's weight, v,
    the attention scratch, the rows' bookkeeping and the two buffers at 128
    columns. Then, in ``RES_ORDER`` while they fit, each weight group's
    rows of the block's units and the block's items' location features;
    what does not fit is read from device memory. The rest widens the
    chunk. Raises only where the fixed part does not fit (decoder_dims far
    past the model's)."""
    B, T, D = dims["B"], dims["T"], dims["D"]
    cap = smem_bytes // 4
    ti = next((t for t in ITEM_SIZES if B * _cdiv(T, t) <= sms), TC)
    nc = _cdiv(T, ti)
    rt = 1 if B == 1 else 8
    groups = weight_groups(dims)
    widest = max(c for _, _, c in groups.values())
    p = dict(nblk=sms, rt=rt, ti=ti, nc=nc, ipb=_cdiv(B * nc, sms), e_smem=0,
             off_e=0, rows=1, kc=0)
    end = HEAD_FLOATS
    for k, n in (("off_conv", LOC_CH * 2 * CONV_K), ("off_v", D),
                 ("off_att", ATT_FLOATS), ("off_rows", 5 * B)):
        p[k] = end
        end += _up4(n)
    p["off_x"] = end
    if rt > 1:
        rows = min(_cdiv(B, 8) * 8, 32)
        while rows > 8 and end + 2 * rows * 128 > cap:
            rows -= 8
        p.update(rows=rows, kc=128)
        end += 2 * rows * 128
    if end > cap:
        raise ValueError(f"no resident decode plan fits {dims} in "
                         f"{smem_bytes} bytes of shared memory")
    sizes = {g: _cdiv(u, sms) * n * c for g, (u, n, c) in groups.items()}
    sizes["e"] = p["ipb"] * TC * D
    for g in RES_ORDER:
        n = _up4(sizes[g])
        fits = end + n <= cap
        key = "e_smem" if g == "e" else f"res_{g}"
        p[key], p[f"off_{g}"] = int(fits), end if fits else 0
        end += n if fits else 0
    gain = 0
    if rt > 1:   # the rest widens the chunk, up to the widest input; the
        # regions behind the buffers move up by what they gain
        rows = p["rows"]
        kc = min(_cdiv(widest, 128) * 128,
                 (2 * rows * 128 + cap - end) // (2 * rows) // 128 * 128)
        gain = 2 * rows * (kc - 128)
        p["kc"] = kc
        for g in RES_ORDER:
            if p[f"off_{g}"]:
                p[f"off_{g}"] += gain
    p["smem_bytes"] = 4 * (end + gain)
    return p


def decode_resident_units(plan, units: int, block: int) -> List[int]:
    """The output units of a ``units``-wide stage that ``block`` owns, in
    its order (the kernel's: k, k + grid, ...)."""
    return list(range(block, units, plan["nblk"]))


def decode_resident_items(plan, B: int, T: int,
                          block: int) -> List[Tuple[int, int, int]]:
    """The attention items ``block`` runs: (row, first position, end)."""
    nc, ti = plan["nc"], plan["ti"]
    return [(i // nc, i % nc * ti, min(T, (i % nc + 1) * ti))
            for i in range(block, B * nc, plan["nblk"])]


def decode_resident_regions(plan, dims) -> Dict[str, Tuple[int, int]]:
    """The plan's shared-memory regions: name -> (offset, floats)."""
    p, D = plan, dims["D"]
    sms = p["nblk"]
    reg = {"mbarrier": (0, 4), "work_views": (4, HEAD_FLOATS - 4),
           "conv": (p["off_conv"], LOC_CH * 2 * CONV_K),
           "v": (p["off_v"], D), "attention": (p["off_att"], ATT_FLOATS),
           "rows": (p["off_rows"], 5 * dims["B"]),
           "chunks": (p["off_x"], 2 * p["rows"] * p["kc"])}
    for g, (u, n, c) in weight_groups(dims).items():
        if p[f"res_{g}"]:
            reg[g] = (p[f"off_{g}"], _cdiv(u, sms) * n * c)
    if p["e_smem"]:
        reg["e"] = (p["off_e"], p["ipb"] * TC * D)
    return reg


# ResArgs of csrc/taco_decode_resident.cu, field for field
_RES_WEIGHTS = ("w1p", "b1p", "w2p", "b2p", "awi", "abi", "awh", "abh", "wq",
                "qb", "conv", "lwt", "v", "wr", "br", "l1wi", "l1wh", "l1b", "l2wi",
                "l2wh", "l2b", "wm")
_ResArgs = type("_ResArgs", (ctypes.Structure,), {"_fields_": (
    [("enc", ctypes.c_void_p), ("encp", ctypes.c_void_p),
     ("mask", ctypes.c_void_p)]
    + [(f, ctypes.c_void_p) for f in _RES_WEIGHTS]
    + [("mel_out", ctypes.c_void_p), ("att_out", ctypes.c_void_p),
       ("n_valid", ctypes.c_void_p), ("work", ctypes.c_void_p),
       ("prof", ctypes.c_void_p)]
    + [(f, ctypes.c_int64) for f in ("B", "T", "E", "D", "P1", "P2", "L",
                                     "n_mels", "r", "n_groups")]
    + [("stop_threshold", ctypes.c_double)])})


def _res_lib():
    lib = _build.load("taco_decode_resident")
    if not getattr(lib, "_typed", False):
        lib.wr_taco_dec_res.argtypes = [ctypes.c_void_p] * 3
        lib.wr_taco_dec_res.restype = ctypes.c_int
        lib.wr_taco_dec_res_work_floats.argtypes = [ctypes.c_void_p] * 2
        lib.wr_taco_dec_res_work_floats.restype = ctypes.c_int64
        lib._typed = True
    return lib


def device_plan(dims, dev) -> Dict[str, int]:
    """``decode_resident_plan`` for the card ``dev``."""
    props = torch.cuda.get_device_properties(dev)
    return decode_resident_plan(
        dims, props.multi_processor_count,
        getattr(props, "shared_memory_per_block_optin", H100_SMEM))


def _resident(dec, encoder_seq, encoder_seq_proj, text_mask, r, steps,
              n_mels, max_r, stop_threshold, profile):
    """One launch of the resident body over the batch."""
    dev = encoder_seq.device
    dims, enc, encp, mask, w = _prepare(dec, encoder_seq, encoder_seq_proj,
                                        text_mask, r, n_mels, max_r)
    if dims["D"] > THREADS:
        raise ValueError(f"the resident decode body takes decoder_dims up "
                         f"to {THREADS}, not {dims['D']}")
    B, T = dims["B"], dims["T"]
    n_groups = steps // r
    F = r * n_mels
    f32 = torch.float32
    mel_out = torch.empty(B, n_groups, F, dtype=f32, device=dev)
    att_out = torch.empty(B, n_groups, T, dtype=f32, device=dev)
    n_valid = torch.empty(B, dtype=torch.int32, device=dev)
    if profile is not None:
        _build.check_operand(profile, "profile", torch.int64,
                             (len(RES_PROF) + len(RES_SUBPROF),), dev)
    plan = _DecPlan(**device_plan(dims, dev))
    args = _ResArgs(
        enc=enc.data_ptr(), encp=encp.data_ptr(), mask=mask.data_ptr(),
        mel_out=mel_out.data_ptr(), att_out=att_out.data_ptr(),
        n_valid=n_valid.data_ptr(),
        prof=profile.data_ptr() if profile is not None else 0,
        n_groups=n_groups, stop_threshold=float(stop_threshold),
        **{k: dims[k] for k in ("B", "T", "E", "D", "P1", "P2", "L",
                                "n_mels", "r")},
        **{k: w[k].data_ptr() for k in _RES_WEIGHTS})
    lib = _res_lib()
    work = torch.zeros(lib.wr_taco_dec_res_work_floats(
        ctypes.byref(args), ctypes.byref(plan)), dtype=f32, device=dev)
    args.work = work.data_ptr()
    _launch(lib.wr_taco_dec_res, args, dev, "resident decode",
            ctypes.byref(plan))
    mel = mel_out.reshape(B, n_groups, r, n_mels).permute(0, 3, 1, 2)
    return mel.reshape(B, n_mels, n_groups * r), att_out, n_valid
