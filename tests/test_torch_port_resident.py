"""The resident sample-loop body's launch plan and routing, on the CPU.

``ops/cuda_gen.resident_plan`` decides which output units each block of
``csrc/sample_loop_resident.cu`` owns and where each shared-memory region
lies; the kernel trusts it, so it is checked here: every unit of every
stage owned exactly once (and as a prefix of each block's slots, which the
kernel reads), the plan within the 232,448-byte budget of an H100 block at
the default widths at any row count (the per-row regions in device
memory where they crowd out the tiles), a plan that cannot fit refused
by name, and the
ctypes mirror of the kernel's argument struct field for field. ``loop_body``
routes a non-empty ``sparse_packed`` (B9) to the original body and every
dense call to the resident one. No JAX and no card: the kernel itself is
held to the original body bit for bit in tests/test_torch_port_cuda.py and
chip_smoke.py's ``resident`` phase.
"""
import re
from pathlib import Path

import pytest
import torch

from wavernn_tpu_torch.ops import cuda_gen as cg

SRC = (Path(cg.__file__).resolve().parents[1] / "csrc"
       / "sample_loop_resident.cu").read_text()


def _regions_disjoint(plan):
    """Every region apart from the others in its memory (shared, or the
    block's device slice for the per-row regions of a ``rows_global``
    plan); fc3's rows may share the unit weights' bytes (wi1 .. w2x) when
    the sampling blocks own no unit."""
    names = [n for n in cg.RESIDENT_REGIONS
             if not (plan.alias_w3 and n == "w3")]
    if plan.alias_w3:
        lo, hi = plan.offsets["wi1"], plan.offsets["w_imel"]
        if plan.offsets["w3"] != lo or plan.sizes["w3"] > hi - lo:
            return False
    for space in (False, True):
        spans = sorted((plan.offsets[n], plan.offsets[n] + plan.sizes[n])
                       for n in names
                       if (plan.rows_global and n in cg.ROW_REGIONS)
                       == space)
        if not all(a[1] <= b[0] for a, b in zip(spans, spans[1:])):
            return False
    return True


@pytest.mark.parametrize("R,FC,sms", [(512, 512, 132), (512, 512, 114),
                                      (256, 128, 132), (64, 64, 132),
                                      (24, 16, 7), (64, 64, 1)])
def test_every_unit_owned_exactly_once(R, FC, sms):
    plan = cg.resident_plan(R, FC, 30, 32, 80, 10, sms)
    assert plan.G == sms
    for units, n, per in ((plan.units_r, R, plan.UR),
                          (plan.units_fc, FC, plan.UF)):
        assert len(units) == sms and all(len(u) == per for u in units)
        owned = sorted(j for u in units for j in u if j >= 0)
        assert owned == list(range(n))
        for u in units:   # the kernel counts a block's units as a prefix
            k = sum(j >= 0 for j in u)
            assert all(j >= 0 for j in u[:k]) and all(j < 0 for j in u[k:])
    if R < sms:   # narrow widths: some blocks own nothing, still planned
        assert any(all(j < 0 for j in u) for u in plan.units_r)
    # the sampling blocks 0..9 own no unit where the others keep at most
    # one GRU item a warp (ten rows take two groups of GRU_ROWS)
    assert plan.exclusive == (10 < sms and -(-R // (sms - 10)) * 2
                              <= cg.RESIDENT_WARPS)
    if plan.exclusive:
        assert all(j < 0 for g in range(10)
                   for j in plan.units_r[g] + plan.units_fc[g])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("NC", [30, 512])
def test_plan_fits_the_budget_at_the_default_config(dtype, NC):
    """Default Config() widths (rnn 512, fc 512, aux 32, 80 mels), MOL's 30
    classes and RAW's 512, 1-64 rows on 132 SMs: within 232,448 bytes,
    16-byte aligned and disjoint regions, at least one tile row, the
    tiles sized to their rows; fc3 resident only where it is small."""
    for B in range(1, 65):
        plan = cg.resident_plan(512, 512, NC, 32, 80, B, 132, dtype, 5)
        assert plan.smem_bytes <= cg.SMEM_BUDGET == 232_448
        assert 1 <= plan.tile_rows <= B
        assert all(v % 16 == 0 for v in plan.offsets.values())
        assert _regions_disjoint(plan)
        assert plan.sizes["tile_a"] == plan.tile_rows * 512 * 4
        assert plan.sizes["tile_b"] >= max(plan.tile_rows, 7) * 512 * 4
        assert plan.w3_resident == (NC == 30)
    # ten rows, the main path's folds, take one tile in either dtype
    assert cg.resident_plan(512, 512, NC, 32, 80, 10, 132, dtype,
                            5).tile_rows == 10


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_fits_any_row_count(dtype):
    """Many rows (a batch of sentences folds into hundreds: ~440 at 44
    five-second sentences, 480 at ten 2,000-frame ones): the per-row
    regions move to device memory once a tile of eight rows no longer fits
    beside them, and the plan stays within the budget with the same tiles
    at any count; below that they stay in shared memory."""
    for B in (65, 128, 132, 133, 440, 480, 500, 1000, 5000):
        plan = cg.resident_plan(512, 512, 30, 32, 80, B, 132, dtype, 5)
        assert plan.smem_bytes <= cg.SMEM_BUDGET
        assert min(B, cg.GRU_ROWS) <= plan.tile_rows <= B
        assert all(v % 16 == 0 for v in plan.offsets.values())
        assert _regions_disjoint(plan)
        row_bytes = sum(-(-plan.sizes[n] // 16) * 16 for n in cg.ROW_REGIONS)
        assert plan.row_bytes == (row_bytes if plan.rows_global else 0)
    # bfloat16 keeps them in shared memory past bench.py's 128 folds,
    # float32 moves them before it; both have moved at 500
    assert not cg.resident_plan(512, 512, 30, 32, 80, 128, 132).rows_global
    assert cg.resident_plan(512, 512, 30, 32, 80, 128, 132, torch.float32,
                            5).rows_global
    assert cg.resident_plan(512, 512, 30, 32, 80, 500, 132, dtype,
                            5).rows_global


def test_plan_that_cannot_fit_raises_naming_the_budget():
    with pytest.raises(ValueError, match="232,448-byte budget"):
        cg.resident_plan(1024, 1024, 30, 32, 80, 10, 132, torch.float32)
    with pytest.raises(ValueError, match="at most 128 columns"):
        cg.resident_plan(512, 512, 30, 32, 160, 10, 132)
    with pytest.raises(ValueError, match="1,024-byte budget"):
        cg.resident_plan(64, 64, 30, 32, 80, 10, 132, torch.float32,
                         budget=1024)


def test_plan_mirrors_the_kernel():
    """RESIDENT_REGIONS in the kernel's Region order, and _ResArgs field
    for field the kernel's ResArgs (names and order)."""
    enum = re.search(r"enum Region \{(.*?)\};", SRC, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",")]
    assert names[-1] == "N_REGIONS"
    assert len(names) - 1 == len(cg.RESIDENT_REGIONS)
    body = re.search(r"struct ResArgs \{(.*?)\};", SRC, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        names_part = decl.split("*")[-1] if "*" in decl else \
            decl.split(None, 1)[1]
        fields += [n.strip().split("[")[0] for n in names_part.split(",")]
    assert fields == [f for f, _ in cg._ResArgs._fields_]


def _core(seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g) * 0.1
    R, FC, A, n_mels, NC = 256, 256, 32, 80, 30
    return {"I.weight": rnd(R, 1 + n_mels + A), "I.bias": rnd(R),
            "rnn1.weight_ih_l0": rnd(3 * R, R),
            "rnn1.weight_hh_l0": rnd(3 * R, R),
            "rnn1.bias_ih_l0": rnd(3 * R), "rnn1.bias_hh_l0": rnd(3 * R),
            "rnn2.weight_ih_l0": rnd(3 * R, R + A),
            "rnn2.weight_hh_l0": rnd(3 * R, R),
            "rnn2.bias_ih_l0": rnd(3 * R), "rnn2.bias_hh_l0": rnd(3 * R),
            "fc1.weight": rnd(FC, R + A), "fc1.bias": rnd(FC),
            "fc2.weight": rnd(FC, FC + A), "fc2.bias": rnd(FC),
            "fc3.weight": rnd(NC, FC), "fc3.bias": rnd(NC)}


def test_sparse_pack_routes_to_the_old_body_dense_to_the_new():
    core = _core()
    assert cg.loop_body(core) == "resident"
    assert cg.loop_body(core, legacy=True) == "fused"
    # nothing sparse enough packs: served dense, on the resident body
    empty = cg.pack_sparse(core)
    assert not empty.entries
    assert cg.loop_body(core, empty) == "resident"
    # one live (128, 128) block in each per-step matrix: the sparse arm
    pruned = dict(core)
    for k in cg._PACK_SOURCES:
        w = torch.zeros_like(core[k])
        w[:128, :128] = core[k][:128, :128]
        pruned[k] = w
    pack = cg.pack_sparse(pruned)
    assert sorted(pack.entries) == sorted(cg.STEP_MATRICES)
    assert cg.loop_body(pruned, pack) == "fused"
    # a stale pack is refused before any routing
    with pytest.raises(ValueError, match="stale"):
        cg.loop_body(core, pack)
