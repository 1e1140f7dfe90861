"""The resident B7 body's launch plan and routing, on the CPU.

``ops/cuda_taco_train.af_resident_plan`` decides, for each direction of
``csrc/taco_train_resident.cu``, which block owns which output unit of
every matrix stage, which attention items (16 text positions of one
utterance) each block runs, what sits in shared memory and what is read
from device memory; the kernel trusts it, so it is checked here: every
unit of every stage owned exactly once, every text position of every
utterance in exactly one item, every plan within the 232,448 bytes of an
H100 block at the attention-forcing configs' batch sizes and text lengths
with its regions apart, a shape beyond the grid's shared memory planned
into device memory without raising, and the ctypes mirror of the kernel's
plan struct field for field. On CPU tensors the AF wrappers run the plain
versions whichever body ``_legacy`` names. No JAX and no card: the kernel
is held to the original body and the plain versions in
tests/test_torch_port_cuda.py and chip_smoke.py's ``b7`` and ``b7res``
phases.
"""
import re
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu_torch.ops import cuda_taco_train as ct

SRC = (Path(ct.__file__).resolve().parents[1] / "csrc"
       / "taco_train_resident.cu").read_text()
H100 = 232448


def _dims(B=32, T=150, G=200, **kw):
    d = dict(G=G, B=B, T=T, E=256, D=256, P1=256, P2=128, L=512, F=160,
             NM=80)
    d.update(kw)
    return d


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("B", [32, 5])
def test_every_unit_of_every_stage_owned_exactly_once(sms, B):
    dims = _dims(B=B)
    plan = ct.af_resident_plan(dims, sms)
    for direction, stages in ct.af_resident_stages(dims).items():
        for name, units in stages.items():
            owned = [u for k in range(sms)
                     for u in ct.af_resident_units(plan, units, k)]
            assert sorted(owned) == list(range(units)), (direction, name)
    # the resident LSTM rows hold every unit a block owns
    most = max(len(ct.af_resident_units(plan, dims["L"], k))
               for k in range(sms))
    assert most == plan["fwd"]["upb_l"]


@pytest.mark.parametrize("B", [32, 16, 8, 5])
@pytest.mark.parametrize("T", [33, 150, 200])
def test_plan_fits_an_h100_block_with_regions_apart(B, T):
    dims = _dims(B=B, T=T)
    plan = ct.af_resident_plan(dims)
    for direction in ("fwd", "bwd"):
        p = plan[direction]
        assert p["smem_bytes"] <= H100
        spans = sorted((o, o + n) for o, n in
                       ct.af_resident_regions(plan, direction, dims).values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] * 4 <= p["smem_bytes"]
        assert all(o % 4 == 0 for o, _ in spans)   # 16-byte aligned
        # a chunk of 8-row tiles at least 128 columns wide, a multiple of 128
        assert 1 <= p["tp"] <= 4 and p["kc"] >= 128 and p["kc"] % 128 == 0
    # at the AF configs' widths both LSTMs' rows stay in shared memory and
    # the backward keeps its location-weight gradient there
    assert plan["fwd"]["res_l1"] and plan["fwd"]["res_l2"]
    assert not plan["bwd"]["gw_global"]
    # the backward's contraction fits its chunks in the same bytes
    bwd = plan["bwd"]
    tt, gc = bwd["epi_tt"], bwd["epi_gc"]
    assert 4 + tt * dims["E"] + gc * (dims["E"] + tt) <= bwd["smem_bytes"] // 4
    assert tt * dims["E"] // 4 <= 8 * ct.RES_THREADS


def test_shape_beyond_shared_memory_plans_into_device_memory():
    # LSTM rows too wide to stay resident: the stages read them through L2
    wide = _dims(L=1024)
    plan = ct.af_resident_plan(wide)
    assert not plan["fwd"]["res_l1"] and not plan["fwd"]["res_l2"]
    assert plan["fwd"]["smem_bytes"] <= H100
    # a long utterance: the context product reads enc through L2
    assert not ct.af_resident_plan(_dims(T=400))["fwd"]["ctx_smem"]
    # a small block: the location-weight gradient moves to device memory
    small = ct.af_resident_plan(_dims(), smem_bytes=100 * 1024)
    assert small["bwd"]["gw_global"]
    for direction in ("fwd", "bwd"):
        assert small[direction]["smem_bytes"] <= 100 * 1024
    # only a shape where not even one tile's chunk fits is refused
    with pytest.raises(ValueError, match="no resident B7 plan fits"):
        ct.af_resident_plan(_dims(), smem_bytes=64 * 1024)


@pytest.mark.parametrize("B,T,sms", [(32, 150, 132), (16, 200, 132),
                                     (5, 33, 132), (8, 150, 7)])
def test_attention_items_cover_every_position_once(B, T, sms):
    plan = ct.af_resident_plan(_dims(B=B, T=T), sms)
    seen = torch.zeros(B, T, dtype=torch.int64)
    for k in range(sms):
        items = ct.af_resident_items(plan, B, T, k)
        assert len(items) <= plan["fwd"]["ipb"]
        for b, t0, t1 in items:
            assert 0 < t1 - t0 <= ct.TC
            seen[b, t0:t1] += 1
    assert bool((seen == 1).all())


def test_plan_mirrors_the_kernel():
    body = SRC[SRC.index("struct ResPlan {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"int64_t ([^;]+);", body)
    names = [n.strip() for f in fields for n in f.split(",")]
    assert tuple(names) == ct.RES_FIELDS
    assert ct._ResPlan._fields_ == [(f, ct.ctypes.c_int64)
                                    for f in ct.RES_FIELDS]
    # the profile labels: one per FProf / BProf enumerator, in order
    for enum, labels in (("FProf", ct.RES_PROF_FWD),
                         ("BProf", ct.RES_PROF_BWD)):
        text = SRC[SRC.index(f"enum {enum} {{"):]
        text = text[:text.index("};")]
        assert len(re.findall(r"\b[FB]P_\w+", text)) == len(labels)
    # the attention scratch the kernel carves up is what the plan reserves
    assert ct.ATT_FWD_FLOATS == 2 * ct.WINP + ct.RES_WARPS * ct.TC + ct.TC + 16
    text = SRC[SRC.index("__device__ __forceinline__ void att_bwd_b("):]
    assert "float* s_dp = part + (nc + 3) / 4 * 4;   // TC x D" in text
    assert ct.att_bwd_floats(256, 10) == (4 * ct.WINP + ct.RES_WARPS * ct.TC
                                          + 2 * ct.TC + 16 + ct.TC * ct.NTAP
                                          + 12 + ct.TC * 256)


def _case(seed=0, B=3, T=20, G=4, train=True):
    gen = torch.Generator().manual_seed(seed)
    E = D = 32
    P1, P2, L, NM, r = 16, 8, 24, 8, 2
    rnd = lambda *s: 0.3 * torch.randn(*s, generator=gen)
    weights = (rnd(P1, NM), rnd(P1), rnd(P2, P1), rnd(P2),
               rnd(3 * D, E + P2), rnd(3 * D), rnd(3 * D, D), rnd(3 * D),
               rnd(D, D), rnd(D), rnd(D, 62), rnd(D), rnd(L, E + D), rnd(L),
               rnd(4 * L, L), rnd(4 * L, L), rnd(4 * L), rnd(4 * L, L),
               rnd(4 * L, L), rnd(4 * L), rnd(r * NM, L))
    aref = torch.rand(G, B, T, generator=gen)
    aref = aref / aref.sum(-1, keepdim=True)
    keep = lambda *s: ((torch.rand(*s, generator=gen) < 0.5).float() * 2.0
                       if train else torch.ones(*s))
    zm = ((torch.rand(2, G, B, L, generator=gen) < 0.1).float() if train
          else torch.zeros(2, G, B, L))
    ins = (aref, keep(G, B, P1), keep(G, B, P2), zm[0], zm[1],
           rnd(B, T, E), rnd(B, T, D))
    return ins, weights


@pytest.mark.parametrize("legacy", [False, True])
def test_cpu_tensors_take_the_plain_versions_on_either_body(legacy):
    ins, w = _case()
    before = {k: getattr(ct.decoder_af, k) for k in (
        "fwd_launches", "bwd_launches", "resident_fwd_launches",
        "resident_bwd_launches", "legacy_fwd_launches",
        "legacy_bwd_launches")}
    mel, sc, st = ct.decoder_af_fwd(*ins, w, save=True, _legacy=legacy)
    mel_p, sc_p, st_p = ct.core_af_ref(*ins, *w, save=True)
    assert torch.equal(mel, mel_p) and torch.equal(sc, sc_p)
    assert all(torch.equal(st[k], st_p[k]) for k in ct.AF_STREAMS)
    gen = torch.Generator().manual_seed(1)
    dmel, dsc = torch.randn(mel.shape, generator=gen), torch.randn(
        sc.shape, generator=gen)
    got = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w, _legacy=legacy)
    want = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m2, s2 = ct.decoder_af(*ins, w, _legacy=legacy)
    assert torch.equal(m2, mel_p) and torch.equal(s2, sc_p)
    # no kernel ran, so no count moved
    assert before == {k: getattr(ct.decoder_af, k) for k in before}


def test_autograd_path_passes_the_switch_through():
    ins, w = _case(seed=2)
    w = tuple(t.clone().requires_grad_(True) for t in w)
    for legacy in (False, True):
        mel, sc = ct.decoder_af(*ins, w, _legacy=legacy)
        g = torch.autograd.grad((mel.sum() + sc.square().sum()), w)
        mel_p, sc_p, _ = ct.core_af_ref(*ins, *w)
        g_p = torch.autograd.grad((mel_p.sum() + sc_p.square().sum()), w)
        for a, b in zip(g, g_p):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
