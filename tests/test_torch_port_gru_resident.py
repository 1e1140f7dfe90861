"""The resident B5 body's launch plan and routing, on the CPU.

``ops/cuda_gru.resident_gru_plan`` mirrors the plan of
``csrc/gru_resident.cu``: which cluster owns which batch rows, which block
of a cluster owns which hidden units, what sits in shared memory and which
reduction indices read their weights from device memory. The kernel
trusts it, so it is checked here: every (row, unit) pair owned exactly
once, every plan within the 232,448 bytes of an H100 block with its
regions counted, the weights in device memory only where the largest
cluster cannot hold wh, and the kernel's plan struct and constants field
for field. On CPU tensors the wrappers run the plain versions whichever
body ``_legacy`` names. No JAX and no card: the ``cuda`` cases (skipped
here) hold the kernel to the plain versions and the first body, and the
C plan to this mirror; chip_smoke.py's ``b5`` and ``b5res`` phases do so
at full size.
"""
import re
from pathlib import Path

import pytest
import torch

from wavernn_tpu_torch.ops import cuda_gru as g

SRC = (Path(g.__file__).resolve().parents[1] / "csrc"
       / "gru_resident.cu").read_text()
H100 = 232448

# the vocoder's training shape at B 32 and 128; the CBHG BiGRUs (H 128) in
# training and at inference (B 1); odd shapes: H 100 at B 3, H 203 (rows
# of 812 / 406 bytes, not 16-byte multiples), H 1024 (wh beyond a cluster)
SHAPES = [(32, 512), (128, 512), (32, 128), (1, 128), (3, 100), (5, 203),
          (3, 1024), (7, 64)]
# (SMs, largest cluster, clusters the card holds at once; 0: SMs / C)
CARDS = [(132, 16, 0), (132, 16, 6), (132, 16, 7), (132, 8, 0), (114, 16, 0),
         (7, 2, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(B, H, backward, card, dtype=torch.float32):
    sms, mc, act = card
    return g.resident_gru_plan(B, H, dtype, backward, sms, mc, act or None)


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,H", SHAPES)
def test_every_row_and_unit_owned_exactly_once(B, H, backward, card):
    p = _plan(B, H, backward, card)
    C, N, R, U = p["cluster"], p["clusters"], p["rows"], p["units"]
    assert 1 <= C <= card[1]
    rows = torch.zeros(B, dtype=torch.int64)
    for i in range(N):
        rows[i * R:min(B, (i + 1) * R)] += 1
    assert bool((rows == 1).all()) and (N - 1) * R < B
    units = torch.zeros(H, dtype=torch.int64)
    for j in range(C):
        units[j * U:min(H, (j + 1) * U)] += 1
    assert bool((units == 1).all())
    # every pair of a cluster has a thread, at most RES_PMAX a thread
    assert R * U <= g.RES_PMAX * g.RES_THREADS
    # the tasks cover every (lane, row group) once; the slices the reduction
    lanes = H // p["no"] if backward else U
    assert p["no"] * lanes == (H if backward else 3 * U)
    assert p["tasks"] == lanes * -(-R // p["rb"])
    assert p["rb"] <= R
    assert p["ks"] * p["kc"] >= p["kp"] and p["kc"] % 4 == 0
    assert p["klen"] == (3 * U if backward else H)
    assert p["kp"] % 4 == 0 and p["klen"] <= p["kp"] < p["klen"] + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,H", SHAPES)
def test_plan_fits_an_h100_block(B, H, backward, dtype):
    for card in CARDS:
        p = _plan(B, H, backward, card, dtype)
        assert p["smem"] <= H100 and p["smem"] % 16 == 0
        assert p["smem"] >= g.RES_SMEM_FLOOR   # one block an SM
        kp = g._res_dims(backward, H, p["units"], p["rows"])[0]
        assert 4 * g.resident_layout_floats(p, H, backward) <= p["smem"]
        # the exchange is pushed where the slices tile the rows exactly
        # (16-byte slices) and the weights are resident
        assert p["push"] in (0, 1) and (not p["push"] or (
            p["units"] % 4 == 0 and p["units"] * p["cluster"] == H
            and p["k_global"] == 0))
        assert p["kres"] % 4 == 0 and 0 <= p["kres"] <= kp
        assert p["k_global"] == kp - p["kres"]
        # weights in device memory only where no cluster the card grants
        # holds wh beside one row
        U = -(-H // card[1])
        kpc, wpkc = g._res_dims(backward, H, U, 1)[:2]
        fits = (kpc * wpkc + g._res_other_floats(backward, H, U, 1)
                <= H100 // 4)
        assert (p["k_global"] == 0) == fits


def test_vocoder_shape_plan():
    """At the vocoder's shape wh lives in clusters of 16 (192 KB a block),
    every cluster runs at once, nothing in device memory; at H 128 a
    cluster of 4 blocks shares it (48 KB a block)."""
    for bw in (False, True):
        for act in (6, 7, 8):
            p = _plan(32, 512, bw, (132, 16, act))
            assert p["cluster"] == 16 and p["k_global"] == 0
            assert p["clusters"] <= act and p["units"] == 32
        p = _plan(32, 128, bw, (132, 16, 0))
        assert p["cluster"] == 4 and p["rows"] == 1 and p["clusters"] == 32
        assert _plan(1, 128, bw, (132, 16, 0))["cluster"] == 4
    # the exchange: pushed at the training shapes in both directions; at
    # B 128 the backward's two partial buffers fill the block and it pulls
    for bw in (False, True):
        assert _plan(32, 512, bw, (132, 16, 7))["push"] == 1
        assert _plan(32, 128, bw, (132, 16, 30))["push"] == 1
    assert _plan(128, 512, True, (132, 16, 7))["push"] == 0
    # a card that grants clusters of 8 at most: wh spills
    assert _plan(32, 512, False, (132, 8, 0))["k_global"] > 0
    # wider than any cluster holds
    assert _plan(3, 1024, True, (132, 16, 0))["k_global"] > 0


def test_plan_mirrors_the_kernel():
    body = SRC[SRC.index("struct GruResPlan {"):]
    body = body[:body.index("};")]
    names = re.findall(r"int64_t (\w+);", body)
    assert tuple(names) == g.RES_FIELDS
    consts = dict(re.findall(r"constexpr int(?:64_t)? (\w+) = ([^;]+);", SRC))
    assert int(consts["THREADS"]) == g.RES_THREADS
    assert int(consts["PMAX"]) == g.RES_PMAX
    assert int(consts["SMEM_BUDGET"]) == g.RES_SMEM_BUDGET
    assert int(consts["SMEM_FLOOR"]) == g.RES_SMEM_FLOOR
    assert eval(consts["PREF_WEIGHTS"]) == g.RES_PREF_WEIGHTS
    assert int(consts["MAX_CLUSTER"]) == g.RES_MAX_CLUSTER
    # the argument structs the wrappers fill
    for struct, mirror in (("GruResFwdArgs", g._ResFwdArgs),
                           ("GruResBwdArgs", g._ResBwdArgs)):
        text = SRC[SRC.index(f"struct {struct} {{"):]
        text = text[:text.index("};")]
        fields = re.findall(r"\*\s*(\w+);", text)
        fields += re.findall(r"int64_t ([^;]+);", text)[0].replace(
            " ", "").split(",")
        assert fields == [f for f, _ in mirror._fields_]


@pytest.mark.parametrize("legacy", [False, True])
def test_cpu_tensors_run_the_plain_versions(legacy):
    gen = torch.Generator().manual_seed(3)
    T, B, H = 5, 3, 12
    gi = torch.randn(T, B, 3 * H, generator=gen)
    wh = torch.randn(H, 3 * H, generator=gen) * 0.3
    bh = torch.randn(3 * H, generator=gen) * 0.1
    h0 = torch.randn(B, H, generator=gen) * 0.1
    dys = torch.randn(T, B, H, generator=gen)
    tm = g.gru_seq_tm
    before = (tm.fwd_launches, tm.bwd_launches, tm.fwd_legacy_launches,
              tm.bwd_legacy_launches)
    ys, sv = g.gru_seq_fwd(gi, wh, bh, h0, _legacy=legacy)
    ys_p, sv_p = g.gru_seq_ref(gi, wh, bh, h0)
    assert torch.equal(ys, ys_p) and torch.equal(sv, sv_p)
    got = g.gru_seq_bwd(sv, ys, wh, h0, dys, _legacy=legacy)
    want = g.gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tm.fwd_launches, tm.bwd_launches, tm.fwd_legacy_launches,
            tm.bwd_legacy_launches) == before


# ---- on the card (marker ``cuda``; skipped without a CUDA device) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc at "
                    "first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=gen) * scale
    return (rnd(T, B, 3 * H, scale=0.5).to(dtype).to(dev),
            rnd(H, 3 * H, scale=H ** -0.5).to(dtype).to(dev),
            rnd(3 * H, scale=0.05).to(dev),
            rnd(B, H, scale=0.3).to(dtype).to(dev),
            rnd(T, B, H, scale=0.1).to(dtype).to(dev))


# float32: summation order only, over at most 40 steps (1e-5 of each
# tensor's largest entry); bfloat16 streams: 3e-2 (a one-ulp rounding flip
# of h carried forward), as tests/test_torch_port_cuda.py
@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype", [
    (1, 3, 100, torch.float32), (17, 5, 203, torch.float32),
    (40, 3, 100, torch.bfloat16), (23, 7, 64, torch.float32),
    (9, 3, 1024, torch.float32)])
def test_resident_body_matches_plain_and_first_body(cuda, T, B, H, dtype):
    gi, wh, bh, h0, dys = _inputs(T, B, H, dtype, cuda)
    tm = g.gru_seq_tm
    f0, b0 = tm.fwd_launches, tm.bwd_launches
    ys, sv = g.gru_seq_fwd(gi, wh, bh, h0)
    dgi, dgh, dh0 = g.gru_seq_bwd(sv, ys, wh, h0, dys)
    ys_p, sv_p = g.gru_seq_ref(gi, wh, bh, h0)
    want = g.gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    ys_l, sv_l = g.gru_seq_fwd(gi, wh, bh, h0, _legacy=True)
    old = g.gru_seq_bwd(sv, ys, wh, h0, dys, _legacy=True)
    torch.cuda.synchronize()
    assert (tm.fwd_launches, tm.bwd_launches) == (f0 + 1, b0 + 1)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for got, ref in ((ys, ys_p), (sv, sv_p), (ys, ys_l), (sv, sv_l)):
        assert float((got.float() - ref.float()).abs().max()) <= tol
    for got, ref, first in zip((dgi, dgh, dh0), want, old):
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale
        assert float((got.float() - first.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_c_plan_equals_python_plan(cuda):
    for B, H in SHAPES + [(200, 512), (64, 256)]:
        for backward in (False, True):
            for sms, mc, act in CARDS:
                want = _plan(B, H, backward, (sms, mc, act))
                got = g.resident_plan_c(B, H, backward, sms, mc, act)
                assert got == {k: want[k] for k in g.RES_FIELDS}
            card = g.resident_launch_plan(B, H, torch.float32, backward)
            want = g.resident_gru_plan(B, H, torch.float32, backward,
                                       card["sms"], card["max_cluster"],
                                       card["active"] or None)
            assert {k: card[k] for k in g.RES_FIELDS} == {
                k: want[k] for k in g.RES_FIELDS}
