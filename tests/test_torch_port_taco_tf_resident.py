"""The resident B6 body's launch plan, routing and algebra, on the CPU.

``ops/cuda_taco_train.tf_resident_plan`` decides, for each direction of
``csrc/taco_tf_resident.cu``, which block owns which output unit of every
matrix stage, which attention items each block runs, and what sits in
shared memory; the kernel trusts it, so it is checked here at the shapes
the TF paths launch: the progressive schedule's r 7 .. 2 (at r 2, 400
groups for 800 frames), the AF-online teacher's eval forward at r 2 and
B 32, odd batches, B 8 and 16, T_text up to 200. The plan's struct is the
B7 body's ``ResPlan`` (one ctypes mirror); the TF body's profile labels
match its enums. On CPU tensors the TF wrappers run the plain versions
whichever body ``_legacy`` names, and count nothing.

The algebra the kernel rests on, in float64 on a tiny shape: the forward's
attention chain run over every group first (the pre half of the GRU's
input product formed before it, the context from the items' unnormalised
partials), then the mel chain on its outputs, mel one product after; the
backward's mel chain over every group first, then the attention chain with
the context cotangent's contraction split into its rnn_input part and
d(gi) of the next group against enc awi[:, :E]^T, d(ctx), d(pre) and
d(enc) products after the loop. Both equal ``core_ref`` /
``core_bwd_ref`` within 1e-5 of each output's largest entry. No JAX and no
card: the kernel is held to the original body and the plain versions in
tests/test_torch_port_cuda.py and chip_smoke.py's ``b6`` and ``b6res``.
"""
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu_torch.ops import cuda_taco_train as ct

SRC = (Path(ct.__file__).resolve().parents[1] / "csrc"
       / "taco_tf_resident.cu").read_text()
H100 = 232448

# (B, T_text, groups, r): the TF schedule's r 7 .. 2 at its longest mel
# (800 frames at r 2: 400 groups), the teacher's eval shape at r 2, odd,
# B 8 / 16, T_text 200
SHAPES = [(32, 150, 100, 7), (32, 150, 160, 5), (32, 150, 267, 3),
          (32, 150, 400, 2), (32, 126, 200, 2), (5, 33, 7, 2),
          (8, 150, 200, 2), (16, 150, 200, 2), (32, 200, 200, 2),
          (3, 20, 6, 2), (7, 199, 3, 2)]


def _dims(B=32, T=150, G=100, r=7, **kw):
    d = dict(G=G, B=B, T=T, E=256, D=256, P2=128, L=512, F=80 * r)
    d.update(kw)
    return d


@pytest.mark.parametrize("sms", [132, 114, 7])
@pytest.mark.parametrize("B", [32, 5])
def test_every_unit_of_every_stage_owned_exactly_once(sms, B):
    dims = _dims(B=B)
    plan = ct.tf_resident_plan(dims, sms)
    for direction, stages in ct.tf_resident_stages(dims).items():
        for name, units in stages.items():
            owned = [u for k in range(sms)
                     for u in ct.af_resident_units(plan, units, k)]
            assert sorted(owned) == list(range(units)), (direction, name)
    most = max(len(ct.af_resident_units(plan, dims["L"], k))
               for k in range(sms))
    assert most == plan["fwd"]["upb_l"]


@pytest.mark.parametrize("B,T,G,r", SHAPES)
def test_plan_fits_an_h100_block_with_regions_apart(B, T, G, r):
    dims = _dims(B, T, G, r)
    plan = ct.tf_resident_plan(dims)
    for direction in ("fwd", "bwd"):
        p = plan[direction]
        assert p["smem_bytes"] <= H100
        spans = sorted((o, o + n) for o, n in ct.af_resident_regions(
            plan, direction, dims, tf=True).values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] * 4 <= p["smem_bytes"]
        assert all(o % 4 == 0 for o, _ in spans)
        assert 1 <= p["tp"] <= 4 and p["kc"] >= 128 and p["kc"] % 128 == 0
        # the products' tiles before the first group and after the last
        assert 4 * (4 + ct.GEMM_TILE_FLOATS) <= p["smem_bytes"]
        assert not p["ctx_smem"]
    assert plan["fwd"]["res_l1"] and plan["fwd"]["res_l2"]
    assert not plan["bwd"]["gw_global"]
    bwd = plan["bwd"]
    tt, gc = bwd["epi_tt"], bwd["epi_gc"]
    assert gc >= 1 and 4 + gc * (dims["E"] + tt) <= bwd["smem_bytes"] // 4
    assert tt * dims["E"] // 4 <= 8 * ct.RES_THREADS
    # phase A's contraction operands fit the attention scratch
    att = ct.af_resident_regions(plan, "bwd", dims, tf=True)["attention"][1]
    assert att >= 32 + dims["E"] + 3 * dims["D"]


@pytest.mark.parametrize("B,T,G,r", SHAPES)
def test_attention_items_cover_every_position_once(B, T, G, r):
    plan = ct.tf_resident_plan(_dims(B, T, G, r))
    seen = torch.zeros(B, T, dtype=torch.int64)
    for k in range(132):
        items = ct.af_resident_items(plan, B, T, k)
        assert len(items) <= plan["fwd"]["ipb"] == plan["bwd"]["ipb"]
        for b, t0, t1 in items:
            assert 0 < t1 - t0 <= ct.TC
            seen[b, t0:t1] += 1
    assert bool((seen == 1).all())


def test_shape_beyond_shared_memory_plans_into_device_memory():
    wide = ct.tf_resident_plan(_dims(L=1024))
    assert not wide["fwd"]["res_l1"] and not wide["fwd"]["res_l2"]
    assert wide["fwd"]["smem_bytes"] <= H100
    small = ct.tf_resident_plan(_dims(), smem_bytes=100 * 1024)
    assert small["bwd"]["gw_global"]
    for direction in ("fwd", "bwd"):
        assert small[direction]["smem_bytes"] <= 100 * 1024
    with pytest.raises(ValueError, match="no resident B6 plan fits"):
        ct.tf_resident_plan(_dims(), smem_bytes=64 * 1024)


def test_plan_and_labels_mirror_the_kernel():
    # the TF body reads the B7 body's ResPlan through the same mirror
    assert "#include \"taco_train_resident.cu\"" in SRC
    assert "ResPlan p" in SRC and "struct ResPlan" not in SRC
    assert ct._ResPlan._fields_ == [(f, ct.ctypes.c_int64)
                                    for f in ct.RES_FIELDS]
    for enum, prefix, labels in (
            ("TFProf", "TF", ct.RES_PROF_TF_FWD),
            ("TBProf", "TB", ct.RES_PROF_TF_BWD),
            ("TFItemProf", "TF_I", ct.RES_PROF_TF_FWD_ITEMS),
            ("TBItemProf", "TB_[AB]", ct.RES_PROF_TF_BWD_ITEMS)):
        text = SRC[SRC.index(f"enum {enum} {{"):]
        text = text[:text.index("};")]
        assert len(re.findall(rf"\b{prefix}_\w+", text)) == len(labels)
    # the items' counters start at 16, after the stages'
    assert "TF_I_WINDOWS = 16" in SRC and "TB_A_LOAD = 16" in SRC
    assert len(ct.RES_PROF_TF_FWD) <= 16 and len(ct.RES_PROF_TF_BWD) <= 16
    # phase A's scratch as the kernel carves it
    text = SRC[SRC.index("void att_a("):]
    assert "float* s_rc = sc + 32;     // E" in text
    assert "float* s_dg = s_rc + up4(E);   // 3D" in text


def _case(seed=0, B=3, T=37, G=4, train=True, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    E = D = 32
    P2, L, r, NM = 8, 24, 2, 8
    rnd = lambda *s: 0.3 * torch.randn(*s, generator=gen, dtype=dtype)
    weights = (rnd(3 * D, E + P2), rnd(3 * D), rnd(3 * D, D), rnd(3 * D),
               rnd(D, D), rnd(D), rnd(D, 62), rnd(D), rnd(L, E + D), rnd(L),
               rnd(4 * L, L), rnd(4 * L, L), rnd(4 * L), rnd(4 * L, L),
               rnd(4 * L, L), rnd(4 * L), rnd(r * NM, L))
    zm = ((torch.rand(2, G, B, L, generator=gen) < 0.1).to(dtype) if train
          else torch.zeros(2, G, B, L, dtype=dtype))
    pre = torch.relu(rnd(G, B, P2)) * 2.0
    ins = (pre, zm[0], zm[1], rnd(B, T, E), rnd(B, T, D))
    return ins, weights


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("legacy", [False, True])
def test_cpu_tensors_take_the_plain_versions_on_either_body(legacy):
    ins, w = _case()
    names = ("fwd_launches", "bwd_launches", "resident_fwd_launches",
             "resident_bwd_launches", "legacy_fwd_launches",
             "legacy_bwd_launches")
    before = {k: getattr(ct.decoder_tf, k) for k in names}
    mel, sc, st = ct.decoder_tf_fwd(*ins, w, save=True, _legacy=legacy)
    mel_p, sc_p, st_p = ct.core_ref(*ins, *w, save=True)
    assert torch.equal(mel, mel_p) and torch.equal(sc, sc_p)
    assert all(torch.equal(st[k], st_p[k]) for k in ct.STREAMS)
    gen = torch.Generator().manual_seed(1)
    dmel = torch.randn(mel.shape, generator=gen)
    dsc = torch.randn(sc.shape, generator=gen)
    got = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w, _legacy=legacy)
    want = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m2, s2 = ct.decoder_tf(*ins, w, _legacy=legacy)
    assert torch.equal(m2, mel_p) and torch.equal(s2, sc_p)
    # the autograd path passes the switch through to the plain versions
    # (the hand-written backward against autograd through the plain forward)
    wg = tuple(t.clone().requires_grad_(True) for t in w)
    m3, s3 = ct.decoder_tf(*ins, wg, _legacy=legacy)
    g = torch.autograd.grad(m3.sum() + s3.square().sum(), wg)
    m4, s4, _ = ct.core_ref(*ins, *wg)
    g4 = torch.autograd.grad(m4.sum() + s4.square().sum(), wg)
    assert torch.equal(m3, m4) and torch.equal(s3, s4)
    assert all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
               for a, b in zip(g, g4))
    assert before == {k: getattr(ct.decoder_tf, k) for k in names}


def _items(T):
    return [(t0, min(T, t0 + ct.TC)) for t0 in range(0, T, ct.TC)]


def _split_forward(pre, zm1, zm2, enc, encp, w):
    """The resident forward's algebra: the attention chain alone, then the
    mel chain on its outputs."""
    (awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b, l2wi,
     l2wh, l2b, wm) = w
    G, B = zm1.shape[:2]
    T, E = enc.shape[1:]
    D, L = wq.shape[0], wr.shape[0]
    z = lambda *s: enc.new_zeros(s)
    gpre = pre @ awi[:, E:].t() + abi          # before the first group
    ah, ctx, cum, att = z(B, D), z(B, E), z(B, T), z(B, T)
    ahs, ctxs, scs = [], [], []
    for g in range(G):
        gi = ctx @ awi[:, :E].t() + gpre[g]
        gh = ah @ awh.t() + abh
        r = torch.sigmoid(gi[:, :D] + gh[:, :D])
        zg = torch.sigmoid(gi[:, D:2 * D] + gh[:, D:2 * D])
        n = torch.tanh(gi[:, 2 * D:] + r * gh[:, 2 * D:])
        ah = (1.0 - zg) * n + zg * ah
        q = ah @ wq.t() + qb
        sig = torch.sigmoid(ct._energy_args(cum, att, q, encp, W01) @ v)
        # each item's partial normaliser and unnormalised context, summed
        # in item order by the utterance's last item
        pdiv = [sig[:, a:b].sum(1) for a, b in _items(T)]
        pctx = [torch.einsum("bt,bte->be", sig[:, a:b], enc[:, a:b])
                for a, b in _items(T)]
        div = sum(pdiv)
        dv = torch.where(div > 0, div, torch.ones_like(div))[:, None]
        ctx = sum(pctx) / dv
        s = sig / dv
        cum, att = cum + s, s
        ahs.append(ah)
        ctxs.append(ctx)
        scs.append(s)
    h1, c1, h2, c2 = z(B, L), z(B, L), z(B, L), z(B, L)
    x2s = []
    for g in range(G):
        x0 = torch.cat([ctxs[g], ahs[g]], 1) @ wr.t() + br
        h1, c1, _ = ct._lstm(x0, h1, c1, zm1[g], l1wi, l1wh, l1b)
        x1 = x0 + h1
        h2, c2, _ = ct._lstm(x1, h2, c2, zm2[g], l2wi, l2wh, l2b)
        x2s.append(x1 + h2)
    return torch.stack(x2s) @ wm.t(), torch.stack(scs)   # mel after the last


def _split_backward(dmel, dsc, st, scores, pre, zm1, zm2, enc, encp, w):
    """The resident backward's algebra: the mel chain's backward over every
    group, then the attention chain's, the products after the loop, the
    weight gradients from the cotangent streams."""
    (awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b, l2wi,
     l2wh, l2b, wm) = w
    G, B = zm1.shape[:2]
    T, E = enc.shape[1:]
    D, L = wq.shape[0], wr.shape[0]
    z = lambda *s: enc.new_zeros(s)
    prev = lambda k, g: st[k][g - 1] if g > 0 else torch.zeros_like(st[k][0])
    dx2 = dmel @ wm                            # before the first group
    encw = enc @ awi[:, :E].t()                # (B, T, 3D), likewise
    dG1s, dG2s, dx0s, rctx, rah = ({} for _ in range(5))
    dh1, dc1, dh2, dc2 = z(B, L), z(B, L), z(B, L), z(B, L)
    for g in range(G - 1, -1, -1):             # the mel chain alone
        dG2, dxin2, dh2, dc2 = ct._lstm_bwd(dh2 + dx2[g], dc2, st["g2"][g],
                                            st["c2"][g], prev("c2", g),
                                            zm2[g], l2wi, l2wh)
        dx1 = dx2[g] + dxin2
        dG1, dxin1, dh1, dc1 = ct._lstm_bwd(dh1 + dx1, dc1, st["g1"][g],
                                            st["c1"][g], prev("c1", g),
                                            zm1[g], l1wi, l1wh)
        dx0 = dx1 + dxin1
        dcat = dx0 @ wr
        dG1s[g], dG2s[g], dx0s[g] = dG1, dG2, dx0
        rctx[g], rah[g] = dcat[:, :E], dcat[:, E:]
    conv_w = torch.stack([W01[:, :ct.CONV_K], W01[:, ct.CONV_K:]], dim=1)
    dcum, datt, dtz = z(B, T), z(B, T), z(B, D)
    dencp, dv_, dW01 = torch.zeros_like(encp), torch.zeros_like(v), \
        torch.zeros_like(W01)
    dgi_n = dgh_n = None
    dgis, dghs, dqs = {}, {}, {}
    for g in range(G - 1, -1, -1):             # the attention chain
        s = scores[g]
        con = torch.einsum("be,bte->bt", rctx[g], enc)
        if dgi_n is not None:
            con = con + torch.einsum("bk,btk->bt", dgi_n, encw)
        ds = dsc[g] + dcum + datt + con
        cum_p, att_p = st["cum"][g], ct.prev_scores(scores, g)
        arg = ct._energy_args(cum_p, att_p, st["q"][g], encp, W01)
        sig = torch.sigmoid(arg @ v)
        div = st["div"][g][:, None]
        S = (ds * s).sum(dim=1, keepdim=True)
        du = torch.where(div > 0, (ds - S) / div, ds) * sig * (1.0 - sig)
        dv_ += torch.einsum("bt,btd->d", du, arg)
        dp = du[:, :, None] * v * (1.0 - arg * arg)
        dencp += dp
        # d(q): the items' partials summed in item order
        dq = sum(dp[:, a:b].sum(1) for a, b in _items(T))
        dW01 += torch.cat(
            [torch.einsum("btd,btk->dk", dp, ct._windows(cum_p)),
             torch.einsum("btd,btk->dk", dp, ct._windows(att_p))], dim=1)
        dlocin = F.conv_transpose1d(dp.transpose(1, 2), conv_w,
                                    padding=ct.CONV_HALF)
        dcum, datt = dcum + dlocin[:, 0], dlocin[:, 1]
        dah = dtz + (dgh_n @ awh if dgh_n is not None else 0.0)
        dh = (dah + rah[g]) + dq @ wq
        gr = st["gru"][g]
        r, zg = gr[:, :D], gr[:, D:2 * D]
        n, hn = gr[:, 2 * D:3 * D], gr[:, 3 * D:]
        dpre_n = dh * (1.0 - zg) * (1.0 - n * n)
        dpre_r = (dpre_n * hn) * r * (1.0 - r)
        dpre_z = dh * (prev("ah", g) - n) * zg * (1.0 - zg)
        dgi_n = torch.cat([dpre_r, dpre_z, dpre_n], -1)
        dgh_n = torch.cat([dpre_r, dpre_z, dpre_n * r], -1)
        dtz = dh * zg
        dgis[g], dghs[g], dqs[g] = dgi_n, dgh_n, dq
    st_ = lambda d: torch.stack([d[g] for g in range(G)])
    dgi, dgh, dq, dx0 = st_(dgis), st_(dghs), st_(dqs), st_(dx0s)
    dG1, dG2 = st_(dG1s), st_(dG2s)
    # after the last group: d(ctx), d(pre), d(enc)
    dctx = st_(rctx) + torch.cat([dgi[1:] @ awi[:, :E], z(1, B, E)])
    dpre = dgi @ awi[:, E:]
    denc = torch.einsum("gbt,gbe->bte", scores, dctx)
    sh = lambda x: torch.cat([torch.zeros_like(x[:1]), x[:-1]])   # x_{g-1}
    mm = lambda a, b: torch.einsum("gbi,gbj->ij", a, b)
    grads = (mm(dgi, torch.cat([sh(st["ctx"]), pre], -1)), dgi.sum((0, 1)),
             mm(dgh, sh(st["ah"])), dgh.sum((0, 1)), mm(dq, st["ah"]),
             dq.sum((0, 1)), dW01, dv_,
             mm(dx0, torch.cat([st["ctx"], st["ah"]], -1)),
             dx0.sum((0, 1)), mm(dG1, st["x0"]), mm(dG1, sh(st["h1"])),
             dG1.sum((0, 1)), mm(dG2, st["x1"]), mm(dG2, sh(st["h2"])),
             dG2.sum((0, 1)), mm(dmel, st["x2"]))
    return (dpre, denc, dencp) + grads


@pytest.mark.parametrize("train", [True, False])
def test_split_chains_equal_the_plain_versions(train):
    ins, w = _case(seed=3, train=train, dtype=torch.float64)
    mel_p, sc_p, st = ct.core_ref(*ins, *w, save=True)
    mel, sc = _split_forward(*ins, w)
    assert _rel(mel, mel_p) <= 1e-5 and _rel(sc, sc_p) <= 1e-5
    gen = torch.Generator().manual_seed(4)
    dmel = torch.randn(mel_p.shape, generator=gen, dtype=torch.float64)
    dsc = torch.randn(sc_p.shape, generator=gen, dtype=torch.float64)
    want = ct.core_bwd_ref(dmel, dsc, st, sc_p, *ins, *w)
    got = _split_backward(dmel, dsc, st, sc_p, *ins, w)
    names = ("dpre", "denc", "dencp") + ct.WEIGHTS
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name
