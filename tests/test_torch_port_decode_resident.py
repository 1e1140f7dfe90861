"""The resident decode body's launch plan and routing, on the CPU.

``ops/cuda_taco.decode_resident_plan`` decides, for
``csrc/taco_decode_resident.cu`` (kernels B2 and B8), which block owns
which output unit of every matrix stage, which attention items (16 text
positions of one row) each block runs, what sits in shared memory and
what is read from device memory; the kernel trusts it, so it is checked
here: every unit of every stage owned exactly once, every text position of
every row in exactly one item, every plan within the 232,448 bytes of an
H100 block with its regions apart for B 1-32, T_text 43-200 and r 1, 2, 7
and 20, a shape beyond the grid's shared memory planned into device memory
without raising, and the ctypes mirrors of the kernel's argument and plan
structs field for field. On CPU tensors ``decode`` and ``decode_batch`` run
the plain version whichever body ``_legacy`` names. No JAX and no card: the
kernel is held to the plain version and the original body in
tests/test_torch_port_cuda_decode.py and chip_smoke.py's ``b8res`` phase.
"""
import re
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu_torch.ops import cuda_taco as ctd

SRC = (Path(ctd.__file__).resolve().parents[1] / "csrc"
       / "taco_decode_resident.cu").read_text()
H100 = 232448


def _dims(B=32, T=43, r=2, **kw):
    d = dict(B=B, T=T, E=256, D=256, P1=256, P2=128, L=512, n_mels=80, r=r)
    d.update(kw)
    return d


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_every_unit_of_every_stage_owned_exactly_once(sms, B):
    dims = _dims(B=B)
    plan = ctd.decode_resident_plan(dims, sms)
    for name, (units, _, _) in ctd.weight_groups(dims).items():
        owned = [u for k in range(sms)
                 for u in ctd.decode_resident_units(plan, units, k)]
        assert sorted(owned) == list(range(units)), name


@pytest.mark.parametrize("B,T,sms", [(1, 42, 132), (5, 43, 132),
                                     (32, 43, 132), (32, 150, 132),
                                     (9, 200, 7), (64, 400, 114)])
def test_attention_items_cover_every_position_once(B, T, sms):
    plan = ctd.decode_resident_plan(_dims(B=B, T=T), sms)
    seen = torch.zeros(B, T, dtype=torch.int64)
    for k in range(sms):
        items = ctd.decode_resident_items(plan, B, T, k)
        assert len(items) <= plan["ipb"]
        for b, t0, t1 in items:
            assert 0 < t1 - t0 <= ctd.TC
            seen[b, t0:t1] += 1
    assert bool((seen == 1).all())


def _apart(plan, dims, smem_bytes):
    regions = sorted(ctd.decode_resident_regions(plan, dims).items(),
                     key=lambda kv: kv[1][0])
    assert plan["smem_bytes"] <= smem_bytes
    end = 0
    for name, (off, n) in regions:
        assert off % 4 == 0, name           # 16-byte aligned for the copies
        assert off >= end, name             # apart from the region before
        end = off + n
    assert 4 * end <= plan["smem_bytes"]
    # a staged pass holds whole tiles of rows, a chunk whole 128-column
    # steps of the lanes; one row is read in place
    if plan["rt"] == 1:
        assert dims["B"] == 1 and plan["kc"] == 0
    else:
        assert plan["rows"] % 8 == 0 and 8 <= plan["rows"] <= 32
        assert plan["kc"] % 128 == 0 and plan["kc"] >= 128


@pytest.mark.parametrize("r", [1, 2, 7, 20])
@pytest.mark.parametrize("B", [1, 2, 5, 8, 9, 16, 32])
def test_plan_fits_an_h100_block_with_regions_apart(B, r):
    for T in (43, 60, 100, 150, 200):
        dims = _dims(B=B, T=T, r=r)
        plan = ctd.decode_resident_plan(dims)
        _apart(plan, dims, H100)
        assert plan["rt"] == (1 if B == 1 else 8)
        # the LSTMs' input halves come first
        assert plan["res_l1wi"] and plan["res_l2wi"]


def test_a_shape_past_shared_memory_plans_into_device_memory():
    """B 64 at T_text 400: the items' location features and some weight
    groups do not fit a block; they go to device memory, no raise."""
    dims = _dims(B=64, T=400)
    plan = ctd.decode_resident_plan(dims)
    _apart(plan, dims, H100)
    assert plan["e_smem"] == 0
    assert plan["ipb"] == -(-64 * 25 // 132)
    # and a card with far less shared memory still gets a plan
    small = ctd.decode_resident_plan(dims, 132, 96 * 1024)
    _apart(small, dims, 96 * 1024)
    assert not all(small[f"res_{g}"] for g in ctd.WEIGHT_GROUPS)


def test_weight_groups_match_the_kernel_operands():
    dims = _dims(r=3)
    dec = _decoder(dims)
    w = ctd.kernel_weights(dec, 3, dims["n_mels"], 20)
    names = {"fc1": "w1p", "fc2": "w2p", "awi": "awi", "awh": "awh",
             "wq": "wq", "wr": "wr", "l1wi": "l1wi", "l1wh": "l1wh",
             "l2wi": "l2wi", "l2wh": "l2wh", "wm": "wm"}
    for g, (units, gates, cols) in ctd.weight_groups(dims).items():
        assert tuple(w[names[g]].shape) == (units * gates, cols), g
    assert tuple(w["lwt"].shape) == (ctd.LOC_CH, dims["D"])
    assert torch.equal(w["lwt"], dec["attn_net.L.weight"].t())


def _fields(struct):
    body = SRC[SRC.index(f"struct {struct} {{"):]
    body = body[:body.index("};")]
    out = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        m = re.match(r"(const float\*|float\*|int32_t\*|long long\*|int64_t|"
                     r"double) (.+);", line)
        if m:
            out += [(m.group(1), n.strip()) for n in m.group(2).split(",")]
    return out


def test_plan_and_args_mirror_the_kernel():
    plan = _fields("DecPlan")
    assert all(t == "int64_t" for t, _ in plan)
    assert tuple(n for _, n in plan) == ctd.DEC_FIELDS
    assert ctd._DecPlan._fields_ == [(f, ctd.ctypes.c_int64)
                                     for f in ctd.DEC_FIELDS]
    args = _fields("ResArgs")
    ctypes_of = {"const float*": ctd.ctypes.c_void_p,
                 "float*": ctd.ctypes.c_void_p,
                 "int32_t*": ctd.ctypes.c_void_p,
                 "long long*": ctd.ctypes.c_void_p,
                 "int64_t": ctd.ctypes.c_int64,
                 "double": ctd.ctypes.c_double}
    assert ctd._ResArgs._fields_ == [(n, ctypes_of[t]) for t, n in args]
    # the profile labels: one per DProf enumerator before DP_N, one per
    # SProf enumerator after them
    for enum, labels in (("DProf", ctd.RES_PROF), ("SProf", ctd.RES_SUBPROF)):
        text = SRC[SRC.index(f"enum {enum} {{"):]
        text = text[:text.index("};")]
        names = re.findall(r"\b[DS]P_\w+", text)
        assert [n for n in names if n != "DP_N"] == names[:len(labels)]
        assert len(names) - ("DP_N" in names) == len(labels)
    # the attention scratch the kernel carves up is what the plan reserves
    assert "constexpr int ATT_FLOATS = ATT_LOC + TC * LOC_CH;" in SRC
    assert f"constexpr int HEAD_FLOATS = 4 + {ctd.HEAD_FLOATS - 4};" in SRC
    assert ctd.ATT_FLOATS == (2 * ctd.WINP + ctd.WARPS * ctd.TC + ctd.TC
                              + 16 + ctd.TC * ctd.LOC_CH)


def _decoder(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    D, E, L = dims["D"], dims["E"], dims["L"]
    P1, P2, NM = dims["P1"], dims["P2"], dims["n_mels"]
    rnd = lambda *s: 0.1 * torch.randn(*s, generator=g)
    return {"prenet.fc1.weight": rnd(P1, NM), "prenet.fc1.bias": rnd(P1),
            "prenet.fc2.weight": rnd(P2, P1), "prenet.fc2.bias": rnd(P2),
            "attn_rnn.weight_ih": rnd(3 * D, E + P2),
            "attn_rnn.bias_ih": rnd(3 * D),
            "attn_rnn.weight_hh": rnd(3 * D, D),
            "attn_rnn.bias_hh": rnd(3 * D),
            "attn_net.W.weight": rnd(D, D), "attn_net.W.bias": rnd(D),
            "attn_net.L.weight": rnd(D, 32), "attn_net.L.bias": rnd(D),
            "attn_net.conv.weight": rnd(32, 2, 31),
            "attn_net.v.weight": rnd(1, D),
            "rnn_input.weight": rnd(L, E + D), "rnn_input.bias": rnd(L),
            "res_rnn1.weight_ih": rnd(4 * L, L),
            "res_rnn1.weight_hh": rnd(4 * L, L),
            "res_rnn1.bias_ih": rnd(4 * L), "res_rnn1.bias_hh": rnd(4 * L),
            "res_rnn2.weight_ih": rnd(4 * L, L),
            "res_rnn2.weight_hh": rnd(4 * L, L),
            "res_rnn2.bias_ih": rnd(4 * L), "res_rnn2.bias_hh": rnd(4 * L),
            "mel_proj.weight": rnd(20 * NM, L)}


@pytest.mark.parametrize("legacy", [False, True])
def test_cpu_tensors_take_the_plain_version_on_either_body(legacy):
    dims = _dims(B=3, T=11, D=32, E=16, P1=16, P2=8, L=24, n_mels=8)
    dec = _decoder(dims, 1)
    g = torch.Generator().manual_seed(2)
    enc = torch.randn(3, 11, 16, generator=g)
    encp = torch.randn(3, 11, 32, generator=g)
    mask = (torch.arange(11)[None] < torch.tensor([11, 6, 9])[:, None]).float()
    tail = (2, 24, 8, 20, -1e30)
    counts = lambda: (ctd.decode.launches, ctd.decode.legacy_launches,
                      ctd.decode_batch.launches,
                      ctd.decode_batch.legacy_launches)
    before = counts()
    with torch.no_grad():
        got = ctd.decode_batch(dec, enc, encp, mask, *tail, _legacy=legacy)
        want = ctd.decode_batch_ref(dec, enc, encp, mask, *tail)
        got1 = ctd.decode(dec, enc[:1], encp[:1], mask[0], *tail,
                          _legacy=legacy)
        want1 = ctd.decode_ref(dec, enc[:1], encp[:1], mask[0], *tail)
    for a, b in zip(got + got1, want + want1):
        assert torch.equal(a, b)
    assert counts() == before   # no kernel launched
