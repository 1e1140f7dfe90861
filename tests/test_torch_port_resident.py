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
routes every call, dense or with a non-empty ``sparse_packed`` (B9), to the
resident body, and only the private ``legacy`` yardstick to the original
one. B9's per-block table (``resident_sparse_table``: the live-chunk masks
of each owned unit's rows, the chunk lists each poll reads) and B10's plan
(no conditioning regions) and stream gather (``gather_streams``) are
checked against the pack and the streams they come from. No JAX and no
card: the kernel itself is held to the original body bit for bit in
tests/test_torch_port_cuda.py and chip_smoke.py's ``resident``,
``sparse`` and ``b10`` phases.
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
    # B9's table: where the kernel finds it, its header's size, its lists
    assert f"constexpr int SPARSE_OFF = {cg.SPARSE_OFF};" in SRC
    assert re.search(rf"N_HEAD = {cg.SPARSE_HEAD}\b", SRC)
    lists = re.search(r"enum List \{(.*?)\};", SRC, re.S).group(1)
    names = [n.strip() for n in lists.split(",")]
    assert names[:names.index("N_LISTS")] == [
        f"L_{n.upper()}" for n in cg.SPARSE_LISTS]


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


def _pruned(core, keep=lambda name, j, r: j == 0 and r == 0):
    """``core`` with only the (128, 128) blocks ``keep`` names live in each
    packed source (output block j, input block r)."""
    pruned = dict(core)
    for k in cg._PACK_SOURCES:
        w = torch.zeros_like(core[k])
        O, I = w.shape
        for j in range(O // 128):
            for r in range(-(-I // 128)):
                if keep(k, j, r):
                    sl = (slice(j * 128, (j + 1) * 128),
                          slice(r * 128, (r + 1) * 128))
                    w[sl] = core[k][sl]
        pruned[k] = w
    return pruned


def test_sparse_pack_routes_to_the_old_body_dense_to_the_new():
    """Every call runs on the resident body, dense or with a non-empty
    pack (B9's arm there); only ``legacy`` (the private yardstick) on the
    original body; a stale pack raises before any routing."""
    core = _core()
    assert cg.loop_body(core) == "resident"
    assert cg.loop_body(core, legacy=True) == "fused"
    # nothing sparse enough packs: served dense, on the resident body
    empty = cg.pack_sparse(core)
    assert not empty.entries
    assert cg.loop_body(core, empty) == "resident"
    # one live (128, 128) block in each per-step matrix: the sparse arm,
    # on the resident body; the yardstick on the original body
    pruned = _pruned(core)
    pack = cg.pack_sparse(pruned)
    assert sorted(pack.entries) == sorted(cg.STEP_MATRICES)
    assert cg.loop_body(pruned, pack) == "resident"
    assert cg.loop_body(pruned, pack, legacy=True) == "fused"
    # a stale pack is refused before any routing
    with pytest.raises(ValueError, match="stale"):
        cg.loop_body(core, pack)
    with pytest.raises(ValueError, match="stale"):
        cg.loop_body(core, pack, legacy=True)


def _blocks_of(mask, br):
    """(out, in / 8) chunk mask -> (out / 128, in / br) live blocks, and
    whether every block is all live or all dead."""
    O, nch = mask.shape
    per = br // 8
    b = mask.reshape(O // 128, 128, nch // per, per)
    return b.any(dim=(1, 3)), bool((b.all(dim=(1, 3)) == b.any(dim=(1, 3)))
                                   .all())


@pytest.mark.parametrize("br", [128, 8])
def test_chunk_masks_equal_the_packs_live_blocks(br):
    """The live-chunk masks are the pack's live blocks, whole blocks at a
    time: (128, 128) blocks cover 16 chunks of 128 rows, the legacy
    (128, 8) ones one chunk; a dead block's chunks are all clear."""
    core = _core(1)
    if br == 128:
        pruned = _pruned(core, lambda k, j, r: (j + r + len(k)) % 5 == 0)
        pack = cg.pack_sparse(pruned)
    else:
        g = torch.Generator().manual_seed(3)
        pruned = dict(core)
        for k in cg._PACK_SOURCES:
            O, I = core[k].shape
            keep = torch.rand(O // 128, I // 8, generator=g) < 0.1
            pruned[k] = core[k] * keep.repeat_interleave(128, 0) \
                .repeat_interleave(8, 1)[:, :I].float()
        pack = cg.pack_sparse(pruned, allow_br8=True)
        assert {m.br for m in pack.entries.values()} == {8}
    assert set(cg.STEP_MATRICES) <= set(pack.entries)
    masks = cg.chunk_masks(pack, 256, 256)
    for name in cg.STEP_MATRICES:
        m = pack.entries[name]
        live, whole = _blocks_of(masks[name], m.br)
        assert whole, name
        want = torch.zeros_like(live)
        for j, rj in enumerate(m.rows):
            want[j, list(rj)] = True
        assert torch.equal(live, want), name
        assert int(masks[name].sum()) == m.live() * 128 * m.br // 8


def test_chunk_masks_all_live_for_a_matrix_left_dense():
    """A pack that leaves some matrices dense (too many live blocks):
    every owned unit's mask is all live for them, the packed ones follow
    their blocks, and the table's words say the same per unit and gate."""
    core = _core(2)
    # wi1 and fc1 keep every block (too dense to pack); the others one
    pruned = _pruned(core, lambda k, j, r: k in ("rnn1.weight_ih_l0",
                                                 "fc1.weight")
                     or (j == 1 and r == 0))
    pack = cg.pack_sparse(pruned)
    assert "wi1" not in pack.entries and "w1x" not in pack.entries
    assert {"wh1", "wi2x", "wh2", "w2x"} <= set(pack.entries)
    masks = cg.chunk_masks(pack, 256, 256)
    assert bool(masks["wi1"].all()) and bool(masks["w1x"].all())
    assert not bool(masks["wh1"].all())
    plan = cg.resident_plan(256, 256, 30, 32, 80, 10, 132, torch.float32, 5,
                            sparse=True)
    table = cg.resident_sparse_table(plan, pack, 256, 256, 10)
    nw = 1   # 32 chunks a row of 256 columns
    for g in (0, 17, 131):
        for s, j in enumerate(plan.units_r[g]):
            for mi, name in enumerate(("wi1", "wh1", "wi2x", "wh2")):
                for gt in range(3):
                    word = int(table[g, 16 + ((s * 4 + mi) * 3 + gt) * nw]) \
                        & 0xFFFFFFFF
                    if j < 0:
                        assert word == 0
                        continue
                    row = masks[name][gt * 256 + j]
                    assert word == sum(1 << c for c in range(32)
                                       if row[c]), (g, s, name, gt)
                    if name == "wi1":
                        assert word == 0xFFFFFFFF


def _lists(plan, table, R, FC):
    """The table's lists by SPARSE_LISTS name, per block."""
    nw_r, nw_f = -(-(R // 8) // 32), -(-(FC // 8) // 32)
    mw = 16 + plan.UR * 12 * nw_r + plan.UF * (nw_r + nw_f)
    lmax = (max(R, FC) // 8 + 1) & ~1
    head = table[:, :16]
    lists_end = mw - 16 + 8 + len(cg.SPARSE_LISTS) * lmax // 2
    assert (head[:, :9] == torch.tensor(
        [nw_r, nw_f, lmax, plan.UR * 12 * nw_r,
         plan.UR * 12 * nw_r + plan.UF * nw_r, mw - 16, lists_end, R, FC],
        dtype=torch.int32)).all()
    assert not head[:, 9:].any()
    # the acting blocks' bits: every block that owns a unit
    act = table[:, 16 + lists_end:].to(torch.int64) & 0xFFFFFFFF
    for g in range(plan.G):
        owns = max(plan.units_r[g] + plan.units_fc[g]) >= 0
        assert bool(act[0, g // 32] >> (g % 32) & 1) == owns
    lens = table[:, mw:mw + 8]
    words = table[:, mw + 8:16 + lists_end].to(torch.int64) & 0xFFFFFFFF
    vals = torch.stack([words & 0xFFFF, words >> 16], dim=-1).reshape(
        plan.G, len(cg.SPARSE_LISTS), lmax)
    return {name: [vals[g, i, :int(lens[g, i])].tolist()
                   for g in range(plan.G)]
            for i, name in enumerate(cg.SPARSE_LISTS)}


@pytest.mark.parametrize("B", [1, 10, 200])
def test_sparse_lists_cover_what_each_stage_reads(B):
    """Each block's fetch lists: increasing, within the vector, and
    covering every chunk its live chunks read at that stage (one tile of
    rows: v for wi1, wi2x and w1x; h1 for wi2x, w1x and wh1; h2 for w1x
    and wh2; several tiles: v for wi1 and its own units, xr for wi2x and
    its own units, x2 for w1x); stage 1 polls at least one chunk of every
    row."""
    core = _pruned(_core(3), lambda k, j, r: (3 * j + r + len(k)) % 7 == 0)
    pack = cg.pack_sparse(core)
    R = FC = 256
    plan = cg.resident_plan(R, FC, 30, 32, 80, B, 132, torch.float32, 5,
                            sparse=True)
    assert plan.smem_bytes <= cg.SMEM_BUDGET
    table = cg.resident_sparse_table(plan, pack, R, FC, B)
    assert table.shape == (plan.G, plan.sparse_words)
    assert table.dtype == torch.int32
    lists = _lists(plan, table, R, FC)
    masks = cg.chunk_masks(pack, R, FC)
    one_tile = plan.tile_rows >= B
    for g in range(plan.G):
        units = [j for j in plan.units_r[g] if j >= 0]
        fcu = [j for j in plan.units_fc[g] if j >= 0]

        def reads(name, us, gates=3, width=R):
            got = set()
            for j in us:
                for gt in range(gates):
                    got |= set(torch.nonzero(masks[name][gt * width + j])
                               .flatten().tolist())
            return got
        c1, ch1 = reads("wi1", units), reads("wh1", units)
        c2, ch2 = reads("wi2x", units), reads("wh2", units)
        c3, c4 = reads("w1x", fcu, 1), reads("w2x", fcu, 1)
        own = {j // 8 for j in units}
        for name, ls in lists.items():
            assert ls[g] == sorted(set(ls[g])), (g, name)
            assert all(0 <= c < (FC if name == "hf1" else R) // 8
                       for c in ls[g])
        got = {n: set(v[g]) for n, v in lists.items()}
        assert got["v"], g
        if one_tile:
            assert c1 | c2 | c3 <= got["v"]
            assert c2 | c3 | ch1 <= got["h1"]
            assert c3 | ch2 <= got["h2"]
            assert not got["xr"] and not got["x2"]
        else:
            assert c1 | own <= got["v"] and c2 | own <= got["xr"]
            assert ch1 <= got["h1"] and ch2 <= got["h2"]
            assert c3 <= got["x2"]
        assert c4 <= got["hf1"]
    # a pruned model polls less than the dense one would at one row
    if B == 1:
        assert sum(len(v) for v in lists["v"]) < plan.G * R // 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 10, 128, 500])
def test_sparse_and_v2_plans_fit_at_the_default_config(dtype, B):
    """Default Config() widths, 132 SMs: B9's plan within the budget with
    its table beside the regions; B10's plan without the conditioning
    matrices' regions, its stream slices (two slots) in shared memory
    until the per-row regions move to device memory, where the kernel
    reads the gathered streams in place; both disjoint and aligned."""
    sp = cg.resident_plan(512, 512, 30, 32, 80, B, 132, dtype, 5,
                          sparse=True)
    assert sp.smem_bytes <= cg.SMEM_BUDGET and _regions_disjoint(sp)
    assert sp.sizes["sparse"] == sp.sparse_words * 4 > 0
    assert sp.sparse_words == cg.sparse_words(512, 512, sp.UR, sp.UF, 132)
    v2 = cg.resident_plan(512, 512, 30, 32, 80, B, 132, dtype, 0, v2=True)
    assert v2.smem_bytes <= cg.SMEM_BUDGET and _regions_disjoint(v2)
    assert all(v2.sizes[n] == 0 for n in cg.COND_REGIONS)
    assert all(v % 16 == 0 for v in v2.offsets.values())
    assert v2.slice_floats == -(-(7 * v2.UR + 2 * v2.UF) * B // 4) * 4
    assert v2.sizes["plane"] == (0 if v2.rows_global
                                 else 2 * v2.slice_floats * 4)
    assert v2.sizes["x_all"] == B * 4
    assert 1 <= v2.tile_rows <= B
    assert v2.rows_global == (B == 500 or (B == 128 and dtype == torch.float32))


def test_gather_streams_puts_each_blocks_slice_in_unit_order():
    """B10's gathered streams: block g's slice of step t holds gi2 (UR, 3,
    B), f1 (UF, B), f2 (UF, B), gi1 (UR, 3, B) and i (UR, B) of its own
    units, zeros in padding slots, float32 from bfloat16 exactly."""
    R, FC, B, T = 64, 48, 3, 5
    plan = cg.resident_plan(R, FC, 30, 8, 80, B, 7, torch.float32, 0,
                            v2=True)
    g = torch.Generator().manual_seed(4)
    widths = (R, 3 * R, 3 * R, FC, FC)
    streams = tuple(torch.randn(T, B, w, generator=g).to(torch.bfloat16)
                    for w in widths)
    got = cg.gather_streams(streams, plan)
    assert got.shape == (T, plan.G, plan.slice_floats)
    assert got.dtype == torch.float32
    UR, UF = plan.UR, plan.UF
    s_i, s_g1, s_g2, s_f1, s_f2 = (s.float() for s in streams)
    off_f1, off_g1 = 3 * UR * B, 3 * UR * B + 2 * UF * B
    for t in (0, T - 1):
        for blk in range(plan.G):
            sl = got[t, blk]
            for s, j in enumerate(plan.units_r[blk]):
                for b in range(B):
                    for gt in range(3):
                        want2 = s_g2[t, b, gt * R + j] if j >= 0 else 0.0
                        want1 = s_g1[t, b, gt * R + j] if j >= 0 else 0.0
                        assert sl[(s * 3 + gt) * B + b] == want2
                        assert sl[off_g1 + (s * 3 + gt) * B + b] == want1
                    want_i = s_i[t, b, j] if j >= 0 else 0.0
                    assert sl[off_g1 + 3 * UR * B + s * B + b] == want_i
            for s, j in enumerate(plan.units_fc[blk]):
                for b in range(B):
                    w1 = s_f1[t, b, j] if j >= 0 else 0.0
                    w2 = s_f2[t, b, j] if j >= 0 else 0.0
                    assert sl[off_f1 + s * B + b] == w1
                    assert sl[off_f1 + UF * B + s * B + b] == w2
            assert not bool(sl[(7 * UR + 2 * UF) * B:].any())
