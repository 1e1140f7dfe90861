"""CUDA tier: the port's hand-written kernels against their plain
versions on the card, at small widths. Marked ``cuda``; each test skips
where torch sees no CUDA device. On a GPU machine without JAX, skip the
suite's conftest (it imports JAX):

    PYTHONPATH=. python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

Tolerance: 2e-3 on samples and mels (float32 on both sides, summation
order only; TF32 off), attention 2e-4, the stop group identical. The GRU
recurrence (B5): float32 ys and sv within 1e-5, dgi, dgh and dh0 within
1e-5 of each tensor's largest entry (summation order only, over at most 40
steps); bfloat16 streams within 3e-2 absolute (ys, sv: a few bf16 ulps at
|v| <= 1, a one-ulp rounding flip of h carried forward) and 3e-2 of the
largest entry (gradients). The Tacotron TF decoder recurrence (B6),
float32, on the resident body and on the original one (``_legacy=True``):
mel, scores, the residual streams and every gradient within 1e-5 of each
tensor's largest entry (summation order only, over at most 7 groups);
either body's forward streams into the other's backward within 1e-5 of
the plain backward on them; a Tacotron train step's loss and gradients on
the card within 1e-4 of the CPU's (the whole model, other library
kernels), its launches and the AF-online teacher's on the resident body.
The
attention-forcing recurrence (B7), float32, on the resident body and on
the original one (``_legacy=True``): mel, scores, the streams, d(aref) and
every gradient within 1e-5 of each tensor's largest entry, as B6; either
body's forward streams into the other's backward, within 1e-5 of the plain
backward on them, and the two forwards' mel chains bit for bit (their
normalisers sum in different orders); an AF-offline train step with the kernels within 1e-5 (loss, relative)
and 1e-4 (each gradient of its largest entry) of the same step with
``recurrence="scan"`` on the card. The materialized sample loop (B3):
samples and the returned state within 2e-3 (as B1), and chained launches
equal to one launch exactly. The batched decode (B8): as B2, every row's
stop group identical. Streaming on the card against one unbatched launch:
at least 99.9 % of samples within 1e-3 (cuDNN may convolve a window with
another algorithm than the whole mel). The sparse arm (B9) of both sample
loops, on the resident body: bit for bit the dense kernel's output on the
same block-pruned weights (its lanes add the same live terms in the same
order) and the original body's sparse arm (``_legacy=True``), float32 and
bfloat16; and, float32, within 2e-3 of its plain version. B1's state arm
(B4b): as B3, samples and state within 2e-3, chained launches and the
exact seams' sequential oracle bit for bit. The pre-projected loop (B10):
float32 within 2e-3; bfloat16 weights and streams, at least 99 % of
samples within 1e-3 of the plain version at the same roundings; on the
resident body bit for bit the original body's arm.
"""
import copy

import pytest
import torch

from wavernn_tpu_torch.config import (DSPConfig, TacotronConfig,
                                      WaveRNNConfig)
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen, cuda_gru, cuda_taco
from wavernn_tpu_torch.ops import cuda_taco_train as ct
from wavernn_tpu_torch.train import pruning
from wavernn_tpu_torch.train import tacotron_train as tt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc at "
                    "first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_sample_loop_kernel_matches_plain(cuda, mode):
    gen = torch.Generator().manual_seed(0)
    voc = wr.WaveRNN(WaveRNNConfig(mode=mode, rnn_dims=64, fc_dims=64,
                                   compute_dims=16, res_out_dims=32,
                                   res_blocks=1), DSPConfig())
    voc.reset_parameters(gen)
    voc = voc.to(cuda).eval()
    # 30 frames: 10 folds, more than one tile of folds in the kernel
    mels = torch.rand(1, 80, 30, generator=gen).to(cuda)
    with torch.no_grad():
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, torch.nn.functional.pad(mels, (2, 2)), 30 * 275, 550, 275)
        args = (voc.core_weights(), frames, phi, geo.hop, -geo.d_lo, chunks,
                mode)
        before = cuda_gen.generate_fused.launches
        got = cuda_gen.generate_fused(*args, seed=3,
                                      compute_dtype=torch.float32)
        want = cuda_gen.generate_fused_ref(*args, seed=3)
    assert cuda_gen.generate_fused.launches == before + 1
    assert got.shape == want.shape == (frames.shape[1], chunks * 275)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("threshold", [-1e30, 10.0])
def test_decode_kernel_matches_plain(cuda, threshold):
    gen = torch.Generator().manual_seed(1)
    tts = taco.Tacotron(TacotronConfig(embed_dims=32, encoder_K=2,
                                       lstm_dims=64, postnet_dims=32,
                                       postnet_K=2, num_highways=1), 80)
    tts.reset_parameters(gen)
    tts = tts.to(cuda).eval()
    ids = torch.randint(1, 148, (1, 20), generator=gen).to(cuda)
    with torch.no_grad():
        enc = tts.encoder(ids)
        encp = enc @ tts.encoder_proj.weight.t()
        mask = torch.ones(20, device=cuda)
        args = (tts.decoder_weights(), enc, encp, mask, 2, 40, 80, 20,
                threshold)
        mel_k, att_k, nv_k = cuda_taco.decode(*args)
        mel_p, att_p, nv_p = cuda_taco.decode_ref(*args)
    assert int(nv_k[0]) == int(nv_p[0]) == (20 if threshold < 0 else 7)
    torch.testing.assert_close(mel_k, mel_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(att_k, att_p, atol=2e-4, rtol=0)


def _gru_inputs(T, B, H, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g) * scale
    return (rnd(T, B, 3 * H, scale=0.5).to(dtype).to(dev),
            rnd(H, 3 * H, scale=H ** -0.5).to(dtype).to(dev),
            rnd(3 * H, scale=0.05).to(dev),
            rnd(B, H, scale=0.1).to(dtype).to(dev),
            rnd(T, B, H, scale=0.1).to(dtype).to(dev))


# H 203 leaves the last block with one unit on a 132-SM card (two units a
# block, 102 blocks); T 1 runs the single-step edge of both sweeps
@pytest.mark.parametrize("T,B,H,dtype", [
    (40, 8, 64, torch.float32), (1, 3, 203, torch.float32),
    (17, 5, 203, torch.float32), (40, 8, 64, torch.bfloat16),
    (17, 5, 203, torch.bfloat16)])
def test_gru_kernels_match_plain(cuda, T, B, H, dtype):
    gi, wh, bh, h0, dys = _gru_inputs(T, B, H, dtype, cuda)
    f0, b0 = cuda_gru.gru_seq_tm.fwd_launches, cuda_gru.gru_seq_tm.bwd_launches
    ys, sv = cuda_gru.gru_seq_fwd(gi, wh, bh, h0)
    ys_p, sv_p = cuda_gru.gru_seq_ref(gi, wh, bh, h0)
    dgi, dgh, dh0 = cuda_gru.gru_seq_bwd(sv, ys, wh, h0, dys)
    want = cuda_gru.gru_seq_bwd_ref(sv, ys, wh, h0, dys)
    torch.cuda.synchronize()
    assert cuda_gru.gru_seq_tm.fwd_launches == f0 + 1
    assert cuda_gru.gru_seq_tm.bwd_launches == b0 + 1
    assert ys.dtype == sv.dtype == dgi.dtype == dgh.dtype == dtype
    assert dh0.dtype == torch.float32
    bf16 = dtype == torch.bfloat16
    tol = 3e-2 if bf16 else 1e-5
    torch.testing.assert_close(ys.float(), ys_p.float(), atol=tol, rtol=0)
    torch.testing.assert_close(sv.float(), sv_p.float(), atol=tol, rtol=0)
    for got, ref in zip((dgi, dgh, dh0), want):
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale


def test_gru_autograd_on_cuda_matches_cpu(cuda):
    """The autograd Function with the kernels against the same Function on
    the CPU (plain versions): all four gradients."""
    gi, wh, bh, h0, dys = _gru_inputs(23, 4, 96, torch.float32, cuda, 1)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (gi, wh, bh,
                                                               h0)]
        ys = cuda_gru.gru_seq_tm(*leaves)
        ys.backward(dys.to(dev))
        outs.append([ys.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, ref in zip(*outs):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * max(scale, 1.0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _b6_inputs(B, T, G, r, dev, train, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = taco.Tacotron(TacotronConfig(), 80)
    model.reset_parameters(gen)
    dec = {k: v.detach().to(dev)
           for k, v in model.decoder_parameters().items()}
    weights = ct.decoder_operands(dec, 20, r, 80)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    zm = ((torch.rand(2, G, B, 512, generator=gen) < 0.1).float() if train
          else torch.zeros(2, G, B, 512))
    ins = (torch.rand(G, B, 128, generator=gen), zm[0], zm[1],
           0.5 * rnd(B, T, 256), 0.5 * rnd(B, T, 256))
    return tuple(t.to(dev) for t in ins), weights


@pytest.mark.parametrize("B,T,G,r,train", [(3, 20, 6, 2, True),
                                           (5, 33, 7, 2, True),
                                           (4, 17, 5, 5, False)])
def test_taco_train_kernels_match_plain(cuda, B, T, G, r, train):
    ins, w = _b6_inputs(B, T, G, r, cuda, train)
    with torch.no_grad():
        before = ct.decoder_tf.fwd_launches
        mel, sc, st = ct.decoder_tf_fwd(*ins, w, save=True)
        mel_p, sc_p, st_p = ct.core_ref(*ins, *w, save=True)
        assert ct.decoder_tf.fwd_launches == before + 1
        assert _rel(mel, mel_p) <= 1e-5 and _rel(sc, sc_p) <= 1e-5
        for k in ct.STREAMS:
            assert _rel(st[k], st_p[k]) <= 1e-5, k
        gen = torch.Generator().manual_seed(1)
        dmel = torch.randn(mel.shape, generator=gen).to(cuda)
        dsc = torch.randn(sc.shape, generator=gen).to(cuda)
        before = ct.decoder_tf.bwd_launches
        got = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w)
        want = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        torch.cuda.synchronize()
        assert ct.decoder_tf.bwd_launches == before + 1
    for name, a, b in zip(("dpre", "denc", "dencp") + ct.WEIGHTS, got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("legacy", [False, True],
                         ids=["resident", "legacy"])
@pytest.mark.parametrize("B,T,G,r,train", [(5, 33, 7, 2, True),
                                           (3, 20, 6, 5, False)])
def test_taco_tf_kernels_match_plain_on_either_body(cuda, B, T, G, r, train,
                                                    legacy):
    """Either B6 body (the resident one, and the original through the
    private ``_legacy``) against the plain versions; each launch counted
    on its body."""
    ins, w = _b6_inputs(B, T, G, r, cuda, train)
    body = "legacy" if legacy else "resident"
    with torch.no_grad():
        own = getattr(ct.decoder_tf, f"{body}_fwd_launches")
        mel, sc, st = ct.decoder_tf_fwd(*ins, w, save=True, _legacy=legacy)
        mel_p, sc_p, st_p = ct.core_ref(*ins, *w, save=True)
        assert getattr(ct.decoder_tf, f"{body}_fwd_launches") == own + 1
        assert _rel(mel, mel_p) <= 1e-5 and _rel(sc, sc_p) <= 1e-5
        for k in ct.STREAMS:
            assert _rel(st[k], st_p[k]) <= 1e-5, k
        gen = torch.Generator().manual_seed(1)
        dmel = torch.randn(mel.shape, generator=gen).to(cuda)
        dsc = torch.randn(sc.shape, generator=gen).to(cuda)
        own = getattr(ct.decoder_tf, f"{body}_bwd_launches")
        got = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w, _legacy=legacy)
        want = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        torch.cuda.synchronize()
        assert getattr(ct.decoder_tf, f"{body}_bwd_launches") == own + 1
        # eval: no streams
        m2, s2, none = ct.decoder_tf_fwd(*ins, w, save=False, _legacy=legacy)
        assert none is None and _rel(m2, mel_p) <= 1e-5
    for name, a, b in zip(("dpre", "denc", "dencp") + ct.WEIGHTS, got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name


def test_taco_tf_crossed_streams(cuda):
    """A forward of either B6 body feeds a backward of the other, each
    against the plain backward on the same streams."""
    ins, w = _b6_inputs(5, 33, 7, 2, cuda, True)
    names = ("dpre", "denc", "dencp") + ct.WEIGHTS
    with torch.no_grad():
        fwd = {lg: ct.decoder_tf_fwd(*ins, w, save=True, _legacy=lg)
               for lg in (False, True)}
        gen = torch.Generator().manual_seed(3)
        dmel = torch.randn(fwd[False][0].shape, generator=gen).to(cuda)
        dsc = torch.randn(fwd[False][1].shape, generator=gen).to(cuda)
        for lg in (False, True):
            _, sc, st = fwd[lg]
            got = ct.decoder_tf_bwd(dmel, dsc, st, sc, *ins, w,
                                    _legacy=not lg)
            want = ct.core_bwd_ref(dmel, dsc, st, sc, *ins, *w)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, want):
                assert _rel(a, b) <= 1e-5, (lg, name)


def test_taco_tf_and_teacher_launch_on_the_resident_body(cuda):
    """The TF step's B6 launches and the AF-online teacher's eval forward
    land on the resident counters, none on the original body's."""
    tts = TacotronConfig(embed_dims=32, postnet_dims=32, encoder_K=2,
                         postnet_K=2, num_highways=1)
    gen = torch.Generator().manual_seed(0)
    model = taco.Tacotron(tts, 80)
    model.reset_parameters(gen)
    model = model.to(cuda)
    B, T, G, r = 3, 19, 6, 2
    x = torch.randint(1, 148, (B, T), generator=gen).to(cuda)
    m = torch.randn(B, 80, G * r, generator=gen).to(cuda)
    names = ("resident_fwd_launches", "resident_bwd_launches",
             "legacy_fwd_launches", "legacy_bwd_launches")
    before = [getattr(ct.decoder_tf, k) for k in names]
    tt.loss_and_grads(model, x, m, r)
    with torch.no_grad():
        attn = tt.teacher_attn_ref(model, x, m, r)
    torch.cuda.synchronize()
    assert attn.shape == (B, G, T) and bool(attn.isfinite().all())
    after = [getattr(ct.decoder_tf, k) for k in names]
    assert [a - b for a, b in zip(after, before)] == [2, 1, 0, 0]


def test_taco_train_step_on_cuda_matches_cpu(cuda):
    tts = TacotronConfig(embed_dims=32, postnet_dims=32, encoder_K=2,
                         postnet_K=2, num_highways=1)
    gen = torch.Generator().manual_seed(0)
    model = taco.Tacotron(tts, 80)
    model.reset_parameters(gen)
    B, T, G, r = 3, 19, 6, 2
    x = torch.randint(1, 148, (B, T), generator=gen)
    m = torch.randn(B, 80, G * r, generator=gen)
    masks = taco.draw_masks(model, B, T, G, gen, "cpu")
    loss_c, _, g_c = tt.loss_and_grads(model, x, m, r, masks=masks)
    model_d = model.to(cuda)
    before = (ct.decoder_tf.fwd_launches, cuda_gru.gru_seq_tm.bwd_launches)
    loss_d, _, g_d = tt.loss_and_grads(
        model_d, x.to(cuda), m.to(cuda), r,
        masks={k: v.to(cuda) for k, v in masks.items()})
    assert ct.decoder_tf.fwd_launches == before[0] + 1
    assert cuda_gru.gru_seq_tm.bwd_launches == before[1] + 4
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    for a, b in zip(g_d, g_c):
        assert _rel(a.cpu(), b) <= 1e-4


def _b7_inputs(B, T, G, r, dev, train, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = taco.Tacotron(TacotronConfig(), 80)
    model.reset_parameters(gen)
    dec = {k: v.detach().to(dev)
           for k, v in model.decoder_parameters().items()}
    weights = ct.af_operands(dec, 20, r, 80)
    aref = torch.rand(G, B, T, generator=gen)
    keep = lambda *s: ((torch.rand(*s, generator=gen) < 0.5).float() * 2.0
                       if train else torch.ones(*s))
    zm = ((torch.rand(2, G, B, 512, generator=gen) < 0.1).float() if train
          else torch.zeros(2, G, B, 512))
    ins = (aref / aref.sum(-1, keepdim=True), keep(G, B, 256),
           keep(G, B, 128), zm[0], zm[1],
           0.5 * torch.randn(B, T, 256, generator=gen),
           0.5 * torch.randn(B, T, 256, generator=gen))
    return tuple(t.to(dev) for t in ins), weights


@pytest.mark.parametrize("legacy", [False, True],
                         ids=["resident", "legacy"])
@pytest.mark.parametrize("B,T,G,r,train", [(5, 33, 7, 2, True),
                                           (3, 20, 6, 5, False)])
def test_taco_af_kernels_match_plain(cuda, B, T, G, r, train, legacy):
    """Either B7 body (the resident one, and the original through the
    private ``_legacy``) against the plain versions; each launch counted
    on its body."""
    ins, w = _b7_inputs(B, T, G, r, cuda, train)
    body = "legacy" if legacy else "resident"
    with torch.no_grad():
        before = ct.decoder_af.fwd_launches
        own = getattr(ct.decoder_af, f"{body}_fwd_launches")
        mel, sc, st = ct.decoder_af_fwd(*ins, w, save=True, _legacy=legacy)
        mel_p, sc_p, st_p = ct.core_af_ref(*ins, *w, save=True)
        assert ct.decoder_af.fwd_launches == before + 1
        assert getattr(ct.decoder_af, f"{body}_fwd_launches") == own + 1
        assert _rel(mel, mel_p) <= 1e-5 and _rel(sc, sc_p) <= 1e-5
        for k in ct.AF_STREAMS:
            assert _rel(st[k], st_p[k]) <= 1e-5, k
        gen = torch.Generator().manual_seed(1)
        dmel = torch.randn(mel.shape, generator=gen).to(cuda)
        dsc = torch.randn(sc.shape, generator=gen).to(cuda)
        before = ct.decoder_af.bwd_launches
        own = getattr(ct.decoder_af, f"{body}_bwd_launches")
        got = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w, _legacy=legacy)
        want = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        torch.cuda.synchronize()
        assert ct.decoder_af.bwd_launches == before + 1
        assert getattr(ct.decoder_af, f"{body}_bwd_launches") == own + 1
    names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS
    assert len(got) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("kind", ["tf", "af"])
def test_taco_kernels_bf16_match_plain(cuda, kind):
    """B6 / B7's bf16 instantiations against their bf16 plain versions at a
    small shape (chip_smoke's bf16 rule: mel and scores within 2e-2 of
    their largest entry in 99 % of the entries, every gradient within
    5e-2); each launch on the bf16 counters; the original body refuses
    bf16 operands."""
    bf = torch.bfloat16
    ins, w = (_b6_inputs if kind == "tf" else _b7_inputs)(5, 33, 7, 2, cuda,
                                                          True)
    names = ct.WEIGHTS if kind == "tf" else ct.AF_WEIGHTS
    ins = tuple(t.to(bf) for t in ins)
    w = tuple(t if n in ct.BIASES else t.to(bf) for n, t in zip(names, w))
    wrap = ct.decoder_tf if kind == "tf" else ct.decoder_af
    fwd = ct.decoder_tf_fwd if kind == "tf" else ct.decoder_af_fwd
    bwd = ct.decoder_tf_bwd if kind == "tf" else ct.decoder_af_bwd
    ref = ct.core_ref if kind == "tf" else ct.core_af_ref
    refb = ct.core_bwd_ref if kind == "tf" else ct.core_af_bwd_ref
    n16 = (wrap.bf16_fwd_launches, wrap.bf16_bwd_launches)
    with torch.no_grad():
        mel, sc, st = fwd(*ins, w, save=True)
        mel_p, sc_p, _ = ref(*ins, *w, save=True)
        for a, b in ((mel, mel_p), (sc, sc_p)):
            err = (a.float() - b.float()).abs()
            assert float((err <= 2e-2 * b.float().abs().max()).float()
                         .mean()) >= 0.99
        gen = torch.Generator().manual_seed(1)
        dmel = torch.randn(mel.shape, generator=gen).to(cuda)
        dsc = torch.randn(sc.shape, generator=gen).to(cuda)
        got = bwd(dmel, dsc, st, sc, *ins, w)
        want = refb(dmel, dsc, st, sc, *ins, *w)
        torch.cuda.synchronize()
    assert mel.dtype == bf and sc.dtype == torch.float32
    assert (wrap.bf16_fwd_launches, wrap.bf16_bwd_launches) == (n16[0] + 1,
                                                                n16[1] + 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a.float(), b.float()) <= 5e-2
    with pytest.raises(ValueError, match="float32"):
        fwd(*ins, w, save=True, _legacy=True)


def test_taco_af_crossed_streams(cuda):
    """A forward of either B7 body feeds a backward of the other: the
    resident forward's streams into the original backward and the
    original's into the resident backward, each against the plain backward
    on the same streams; the two forwards' mel chains bit for bit."""
    ins, w = _b7_inputs(5, 33, 7, 2, cuda, True)
    names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS
    with torch.no_grad():
        fwd = {lg: ct.decoder_af_fwd(*ins, w, save=True, _legacy=lg)
               for lg in (False, True)}
        assert torch.equal(fwd[False][0], fwd[True][0])
        for k in ct.AF_STREAMS:
            if k not in ("cum", "div"):   # the normaliser's order differs
                assert torch.equal(fwd[False][2][k], fwd[True][2][k]), k
        gen = torch.Generator().manual_seed(3)
        dmel = torch.randn(fwd[False][0].shape, generator=gen).to(cuda)
        dsc = torch.randn(fwd[False][1].shape, generator=gen).to(cuda)
        for lg in (False, True):
            _, sc, st = fwd[lg]
            got = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w,
                                    _legacy=not lg)
            want = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *w)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, want):
                assert _rel(a, b) <= 1e-5, (lg, name)


def test_taco_af_offline_step_kernels_match_scan(cuda):
    tts = TacotronConfig(embed_dims=32, postnet_dims=32, encoder_K=2,
                         postnet_K=2, num_highways=1)
    gen = torch.Generator().manual_seed(0)
    model = taco.Tacotron(tts, 80)
    model.reset_parameters(gen)
    model = model.to(cuda)
    B, T, G, r = 3, 19, 6, 2
    x = torch.randint(1, 148, (B, T), generator=gen).to(cuda)
    m = torch.randn(B, 80, G * r, generator=gen).to(cuda)
    aref = torch.rand(B, G, T, generator=gen)
    aref = (aref / aref.sum(-1, keepdim=True)).to(cuda)
    masks = {k: v.to(cuda) for k, v in
             taco.draw_masks(model, B, T, G, gen, "cpu").items()}
    out = {}
    for rec in ("auto", "scan"):
        before = ct.decoder_af.bwd_launches
        res = (ct.decoder_af.resident_fwd_launches,
               ct.decoder_af.resident_bwd_launches)
        old = (ct.decoder_af.legacy_fwd_launches,
               ct.decoder_af.legacy_bwd_launches)
        loss, _, _, _, g = tt.loss_and_grads_af(
            copy.deepcopy(model), x, m, aref, r, 200.0, True, rec, masks)
        assert ct.decoder_af.bwd_launches == before + (rec == "auto")
        # the step's launches land on the resident body, none on the old
        assert (ct.decoder_af.resident_fwd_launches,
                ct.decoder_af.resident_bwd_launches) == tuple(
                    n + (rec == "auto") for n in res)
        assert (ct.decoder_af.legacy_fwd_launches,
                ct.decoder_af.legacy_bwd_launches) == old
        out[rec] = (float(loss), g)
    (lk, gk), (ls, gs) = out["auto"], out["scan"]
    assert abs(lk - ls) <= 1e-5 * abs(ls)
    for a, b in zip(gk, gs):
        assert _rel(a, b) <= 1e-4


def _small_voc(mode, cuda, seed):
    gen = torch.Generator().manual_seed(seed)
    voc = wr.WaveRNN(WaveRNNConfig(mode=mode, rnn_dims=64, fc_dims=64,
                                   compute_dims=16, res_out_dims=32,
                                   res_blocks=1), DSPConfig())
    voc.reset_parameters(gen)
    return voc.to(cuda).eval(), gen


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_materialized_kernel_matches_plain_and_chains(cuda, mode):
    """B3 at an odd shape (B 3, T 333) against its plain version, float32
    weights; then the state handoff: one launch of T steps equals two
    chained launches under the same noise, bit for bit, and a snapshot at
    step s equals the state an s-step launch returns."""
    voc, gen = _small_voc(mode, cuda, 4)
    B, T, T1 = 3, 333, 140
    NC = voc.core_weights()["fc3.weight"].shape[0]
    mels_up = torch.rand(B, T, 80, generator=gen).to(cuda)
    aux = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
    state = tuple(t.to(cuda) for t in (torch.rand(B, 64, generator=gen) - 0.5,
                                       torch.rand(B, 64, generator=gen) - 0.5,
                                       torch.rand(B, generator=gen) - 0.5))
    nu = NC // 3 + 1 if mode == "MOL" else NC
    u = cuda_gen.counter_uniforms(5, T, B, nu, mode == "MOL", cuda)
    noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
    cut = (lambda n, a, b: tuple(v[a:b] for v in n) if mode == "MOL"
           else n[a:b])
    core = voc.core_weights()
    f32 = torch.float32
    with torch.no_grad():
        before = cuda_gen.generate_materialized.launches
        y, st = cuda_gen.generate_materialized(
            core, mels_up, aux, mode, noise=noise, init_state=state,
            compute_dtype=f32)
        y_p, st_p = cuda_gen.generate_materialized_ref(
            core, mels_up, aux, mode, noise=noise, init_state=state)
        assert cuda_gen.generate_materialized.launches == before + 1
        torch.testing.assert_close(y, y_p, atol=2e-3, rtol=0)
        for a, b in zip(st, st_p):
            torch.testing.assert_close(a, b, atol=2e-3, rtol=0)
        y1, st1 = cuda_gen.generate_materialized(
            core, mels_up[:, :T1], aux[:, :T1], mode,
            noise=cut(noise, 0, T1), init_state=state, compute_dtype=f32)
        y2, st2 = cuda_gen.generate_materialized(
            core, mels_up[:, T1:], aux[:, T1:], mode,
            noise=cut(noise, T1, T), init_state=st1, compute_dtype=f32)
        _, snap = cuda_gen.generate_materialized(
            core, mels_up, aux, mode, noise=noise, init_state=state,
            state_snapshot_at=T1, compute_dtype=f32)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    for a, b in zip(st2, st):
        assert torch.equal(a, b)
    for a, b in zip(snap, st1):
        assert torch.equal(a, b)


def _mixed_stop_threshold(mel, r):
    """From a decode that never stopped, a threshold at which the rows stop
    at different groups (the first group g with g*r > 10 whose largest
    value is below it), the widest margin among those with the most:
    (threshold, each row's n_valid under it)."""
    B, n_mels, steps = mel.shape
    G = steps // r
    peaks = mel.reshape(B, n_mels, G, r).amax(dim=(1, 3)).cpu()
    vals = torch.unique(peaks[:, [g for g in range(G) if g * r > 10]])
    best = None
    for lo, hi in zip(vals[:-1].tolist(), vals[1:].tolist()):
        thr = (lo + hi) / 2
        stops = [next((g + 1 for g in range(G)
                       if g * r > 10 and peaks[b, g] < thr), G)
                 for b in range(B)]
        score = (len(set(stops)), hi - lo)
        if best is None or score > best[0]:
            best = (score, thr, stops)
    return best[1], best[2]


@pytest.mark.parametrize("B", [3, 11])
def test_batched_decode_kernel_matches_plain(cuda, B):
    """B8 at B 3 and 11 (one launch for every B), mixed text lengths: no
    stop, every row stopped at its first eligible group (frozen replay),
    and a threshold at which the rows stop at different groups."""
    gen = torch.Generator().manual_seed(2)
    tts = taco.Tacotron(TacotronConfig(embed_dims=32, encoder_K=2,
                                       lstm_dims=64, postnet_dims=32,
                                       postnet_K=2, num_highways=1), 80)
    tts.reset_parameters(gen)
    tts = tts.to(cuda).eval()
    lens = torch.randint(5, 24, (B,), generator=gen)
    lens[0] = 24
    ids = torch.randint(1, 148, (B, 24), generator=gen)
    ids = (ids * (torch.arange(24)[None] < lens[:, None])).to(cuda)
    lens = lens.to(cuda)
    with torch.no_grad():
        enc = tts.encoder(ids, lens=lens)
        mask = (torch.arange(24, device=cuda)[None] < lens[:, None]).float()
        enc = enc * mask[..., None]
        encp = (enc @ tts.encoder_proj.weight.t()) * mask[..., None]
        dec = tts.decoder_weights()
        base = (enc, encp, mask, 2, 60, 80, 20)
        # rows stop at different groups only where their group maxima fall
        # after group 6, which depends on the weights: mel_proj as drawn
        # and negated, the one with more stop groups
        picks = []
        for sign in (1.0, -1.0):
            d = {**dec, "mel_proj.weight": sign * dec["mel_proj.weight"]}
            thr, stops = _mixed_stop_threshold(
                cuda_taco.decode_batch_ref(d, *base, -1e30)[0], 2)
            picks.append((len(set(stops)), d, thr))
        _, mixed, thr = max(picks, key=lambda p: p[0])
        for d, threshold, want_nv in ((dec, -1e30, [30] * B),
                                      (dec, 10.0, [7] * B),
                                      (mixed, thr, None)):
            before = cuda_taco.decode_batch.launches
            mel_k, att_k, nv_k = cuda_taco.decode_batch(d, *base, threshold)
            mel_p, att_p, nv_p = cuda_taco.decode_batch_ref(d, *base,
                                                            threshold)
            assert cuda_taco.decode_batch.launches == before + 1
            assert nv_k.tolist() == nv_p.tolist()
            assert want_nv is None or nv_p.tolist() == want_nv
            torch.testing.assert_close(mel_k, mel_p, atol=2e-3, rtol=0)
            torch.testing.assert_close(att_k, att_p, atol=2e-4, rtol=0)


def test_streaming_matches_unbatched_offline(cuda):
    """StreamingVocoder on the card (B3 per block, the state handed on)
    against one unbatched B3 launch over the whole utterance with the same
    noise: at least 99.9 % of samples within 1e-3 (cuDNN may pick another
    convolution algorithm for a window than for the whole mel)."""
    from wavernn_tpu_torch.streaming import StreamingVocoder
    voc, gen = _small_voc("MOL", cuda, 6)
    frames = 40
    mels = torch.rand(80, frames, generator=gen).to(cuda)
    T = frames * 275
    u = cuda_gen.counter_uniforms(7, T, 1, 11, True, cuda)
    noise = (u[..., :10], u[..., 10])
    with torch.no_grad():
        mu, au = voc.upsample(torch.nn.functional.pad(mels[None], (2, 2)))
        want, _ = cuda_gen.generate_materialized(voc.core_weights(), mu, au,
                                                 "MOL", noise=noise)
    sv = StreamingVocoder(voc, chunk_frames=7, noise=noise, device=cuda)
    got = torch.cat([torch.as_tensor(sv.feed(mels[:, :17])),
                     torch.as_tensor(sv.feed(mels[:, 17:])),
                     torch.as_tensor(sv.flush())]).to(cuda)
    assert got.shape == (T,)
    share = float(((got - want[0]).abs() <= 1e-3).float().mean())
    assert share >= 0.999, share


@pytest.mark.parametrize("mode,dtype", [("MOL", torch.float32),
                                        ("MOL", torch.bfloat16),
                                        ("RAW", torch.float32),
                                        ("RAW", torch.bfloat16)])
def test_sparse_arm_equals_dense_kernel(cuda, mode, dtype):
    """B9 in B1 and B3 at rnn and fc 256, (128, 128) blocks pruned at
    93.75 % (one live block of each gate split's four), 1, 3 and 10 rows
    (10 crosses the old body's 8-row tile): the resident sparse arm equals
    the dense arm on the same masked weights and the original body's
    sparse arm exactly, matches its plain version (float32), and counts
    its launches on the resident body."""
    gen = torch.Generator().manual_seed(11)
    voc = wr.WaveRNN(WaveRNNConfig(mode=mode, rnn_dims=256, fc_dims=256,
                                   compute_dims=16, res_out_dims=32,
                                   res_blocks=1), DSPConfig())
    voc.reset_parameters(gen)
    voc = voc.to(cuda).eval()
    params = dict(voc.named_parameters())
    pruning.apply_masks(params, pruning.update_masks(
        params, 100, pruning.wavernn_prune_spec(), 0, 100, 0.9375,
        (128, 128)))
    core = voc.core_weights()
    pack = cuda_gen.pack_sparse(core, voc.voc)
    assert sorted(pack.entries) == sorted(cuda_gen.STEP_MATRICES)
    NC = core["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    geo_phi = wr.fused_conditioning(
        voc, torch.nn.functional.pad(torch.rand(1, 80, 8, generator=gen)
                                     .to(cuda), (2, 2)), 8 * 275, 550, 275)
    _, phi, geo, _ = geo_phi
    chunks = 2
    for B in (1, 3, 10):
        T = chunks * geo.hop
        u = cuda_gen.counter_uniforms(B, T, B, nu, mode == "MOL", cuda)
        noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
        frames = torch.rand(chunks + geo.K - 1, B, 80 + 32,
                            generator=gen).to(cuda)
        fargs = (core, frames, phi, geo.hop, -geo.d_lo, chunks, mode)
        mu = torch.rand(B, T, 80, generator=gen).to(cuda)
        au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
        with torch.no_grad():
            n0 = (cuda_gen.generate_fused.sparse_launches,
                  cuda_gen.generate_materialized.sparse_launches)
            dense = cuda_gen.generate_fused(*fargs, noise=noise,
                                            compute_dtype=dtype)
            sparse = cuda_gen.generate_fused(*fargs, noise=noise,
                                             compute_dtype=dtype,
                                             sparse_packed=pack)
            mdense, mst = cuda_gen.generate_materialized(
                core, mu, au, mode, noise=noise, compute_dtype=dtype)
            msparse, msst = cuda_gen.generate_materialized(
                core, mu, au, mode, noise=noise, compute_dtype=dtype,
                sparse_packed=pack)
            assert (cuda_gen.generate_fused.sparse_launches,
                    cuda_gen.generate_materialized.sparse_launches) \
                == (n0[0] + 1, n0[1] + 1)
            assert torch.equal(sparse, dense), B
            assert torch.equal(msparse, mdense), B
            for a, b in zip(msst, mst):
                assert torch.equal(a, b), B
            old = cuda_gen.generate_fused(*fargs, noise=noise,
                                          compute_dtype=dtype,
                                          sparse_packed=pack, _legacy=True)
            mold = cuda_gen.generate_materialized(
                core, mu, au, mode, noise=noise, compute_dtype=dtype,
                sparse_packed=pack, _legacy=True)
            assert torch.equal(sparse, old), B
            assert _same((msparse, msst), mold), B
            if dtype == torch.float32:
                want = cuda_gen.generate_fused_ref(*fargs, noise=noise,
                                                   sparse_packed=pack)
                torch.testing.assert_close(sparse, want, atol=2e-3, rtol=0)
                mwant, _ = cuda_gen.generate_materialized_ref(
                    core, mu, au, mode, noise=noise, sparse_packed=pack)
                torch.testing.assert_close(msparse, mwant, atol=2e-3, rtol=0)


def test_sparse_arm_legacy_br8_equals_dense(cuda):
    """The legacy schedule (``allow_br8``): (8, 128) block masks pack as
    blocks of 128 output rows by 8 input columns, one chunk of one lane
    each; the resident sparse arm still equals the dense arm and the
    original body's sparse arm exactly."""
    gen = torch.Generator().manual_seed(12)
    voc = wr.WaveRNN(WaveRNNConfig(rnn_dims=256, fc_dims=256,
                                   compute_dims=16, res_out_dims=32,
                                   res_blocks=1), DSPConfig())
    voc.reset_parameters(gen)
    voc = voc.to(cuda).eval()
    params = dict(voc.named_parameters())
    pruning.apply_masks(params, pruning.update_masks(
        params, 100, pruning.wavernn_prune_spec(), 0, 100, 0.9375, (8, 128)))
    core = voc.core_weights()
    pack = cuda_gen.pack_sparse(core, voc.voc, allow_br8=True)
    assert {pack.entries[n].br for n in ("wi1", "wh1", "wh2")} == {8}
    B, T = 3, 400
    mu = torch.rand(B, T, 80, generator=gen).to(cuda)
    au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dense, _ = cuda_gen.generate_materialized(
                core, mu, au, "MOL", seed=4, compute_dtype=dtype)
            sparse, _ = cuda_gen.generate_materialized(
                core, mu, au, "MOL", seed=4, compute_dtype=dtype,
                sparse_packed=pack)
            old, _ = cuda_gen.generate_materialized(
                core, mu, au, "MOL", seed=4, compute_dtype=dtype,
                sparse_packed=pack, _legacy=True)
            assert torch.equal(sparse, dense), dtype
            assert torch.equal(sparse, old), dtype


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_fused_state_kernel_matches_plain_and_chains(cuda, mode):
    """B4b, B1's state arm, at 3 rows x 6 hop chunks from a given state:
    against its plain version with a snapshot inside the launch (float32
    weights, 2e-3); then one launch equals two chained at chunk boundary 2
    (the second from frames[2:] and the noise from step 2*hop on), bit for
    bit, and a snapshot at that boundary equals the shorter launch's final
    state. B1's own count does not move."""
    voc, gen = _small_voc(mode, cuda, 21)
    B, chunks, c1 = 3, 6, 2
    _, phi, geo, _ = wr.fused_conditioning(
        voc, torch.nn.functional.pad(torch.rand(1, 80, 8, generator=gen)
                                     .to(cuda), (2, 2)), 8 * 275, 550, 275)
    hop, tap = geo.hop, -geo.d_lo
    T, T1 = chunks * hop, c1 * hop
    frames = torch.rand(chunks + geo.K - 1, B, 80 + 32,
                        generator=gen).to(cuda)
    state = tuple(t.to(cuda) for t in (torch.rand(B, 64, generator=gen) - 0.5,
                                       torch.rand(B, 64, generator=gen) - 0.5,
                                       torch.rand(B, generator=gen) - 0.5))
    NC = voc.core_weights()["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    u = cuda_gen.counter_uniforms(6, T, B, nu, mode == "MOL", cuda)
    noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
    cut = (lambda n, a, b: tuple(v[a:b] for v in n) if mode == "MOL"
           else n[a:b])
    core = voc.core_weights()
    f32 = torch.float32
    with torch.no_grad():
        before = (cuda_gen.generate_fused.launches,
                  cuda_gen.generate_fused_with_state.launches)
        y, snap = cuda_gen.generate_fused_with_state(
            core, frames, phi, hop, tap, chunks, mode, noise=noise,
            init_state=state, state_snapshot_at=700, compute_dtype=f32)
        y_p, snap_p = cuda_gen.generate_fused_with_state_ref(
            core, frames, phi, hop, tap, chunks, mode, noise=noise,
            init_state=state, state_snapshot_at=700)
        assert (cuda_gen.generate_fused.launches,
                cuda_gen.generate_fused_with_state.launches) == (
                    before[0], before[1] + 1)
        torch.testing.assert_close(y, y_p, atol=2e-3, rtol=0)
        for a, b in zip(snap, snap_p):
            torch.testing.assert_close(a, b, atol=2e-3, rtol=0)
        y, st = cuda_gen.generate_fused_with_state(
            core, frames, phi, hop, tap, chunks, mode, noise=noise,
            init_state=state, compute_dtype=f32)
        y1, st1 = cuda_gen.generate_fused_with_state(
            core, frames[:c1 + geo.K - 1].contiguous(), phi, hop, tap, c1,
            mode, noise=cut(noise, 0, T1), init_state=state,
            compute_dtype=f32)
        y2, st2 = cuda_gen.generate_fused_with_state(
            core, frames[c1:].contiguous(), phi, hop, tap, chunks - c1, mode,
            noise=cut(noise, T1, T), init_state=st1, compute_dtype=f32)
        _, snap = cuda_gen.generate_fused_with_state(
            core, frames, phi, hop, tap, chunks, mode, noise=noise,
            init_state=state, state_snapshot_at=T1, compute_dtype=f32)
        # with no state in and a snapshot at T, B4b is B1 bit for bit
        b1 = cuda_gen.generate_fused(core, frames, phi, hop, tap, chunks,
                                     mode, noise=noise, compute_dtype=f32)
        b4 = cuda_gen.generate_fused_with_state(
            core, frames, phi, hop, tap, chunks, mode, noise=noise,
            compute_dtype=f32)[0]
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    for a, b in zip(st2, st):
        assert torch.equal(a, b)
    for a, b in zip(snap, st1):
        assert torch.equal(a, b)
    assert torch.equal(b4, b1)


def test_exact_seams_reproduce_one_sequential_launch(cuda):
    """The sequential oracle (tests/test_seam.py:21-65) on the card: on an
    utterance that folds exactly into 3 folds, with the noise laid out so
    that fold i's local step j is global step i*seg + j, 2 passes of the
    fused seam (B4b) equal one one-row fused launch over the whole span,
    and 2 passes of the materialized seam (B3) one unbatched B3 launch, bit
    for bit (each row's sums run in one order whatever the batch)."""
    from wavernn_tpu_torch.ops import fold
    from wavernn_tpu_torch.ops import polyphase as P
    from wavernn_tpu_torch.parallel import gen_sharded as gs
    voc, gen = _small_voc("MOL", cuda, 22)
    core = voc.core_weights()
    target, overlap, n = 550, 275, 3
    seg, L = target + overlap, target + 2 * overlap
    total = n * seg + overlap
    u = cuda_gen.counter_uniforms(8, total, 1, 11, True, cuda)
    g = (torch.arange(n, device=cuda)[None] * seg
         + torch.arange(L, device=cuda)[:, None])
    noise_1 = (u[..., :10], u[..., 10])
    noise_f = (u[g, 0, :10], u[g, 0, 10])
    mels = torch.rand(1, 80, total // 275, generator=gen).to(cuda)
    mels_p = torch.nn.functional.pad(mels, (2, 2))
    with torch.no_grad():
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, mels_p, total, target, overlap)
        one = P.build_folded_frames(mels_p[0].t(),
                                    voc.upsample.resnet(mels_p)[0].t(), 1, 0,
                                    total // 275, geo.K, geo.d_lo)
        for dtype in (torch.float32, torch.bfloat16):
            seq = cuda_gen.generate_fused(core, one, phi, geo.hop, -geo.d_lo,
                                          total // 275, "MOL",
                                          noise=noise_1, compute_dtype=dtype)
            y, _ = gs.generate_exact_seam_fused(
                core, frames, phi, geo.hop, -geo.d_lo, chunks, "MOL", target,
                overlap, seam_passes=n - 1, noise=noise_f,
                compute_dtype=dtype)
            assert torch.equal(gs.concat_folds(y, target, overlap, total),
                               seq[0]), dtype
        mu, au = voc.upsample(mels_p)
        seq, _ = cuda_gen.generate_materialized(core, mu, au, "MOL",
                                                noise=noise_1)
        y, _ = gs.generate_exact_seam(
            core, fold.fold_with_overlap(mu, target, overlap),
            fold.fold_with_overlap(au, target, overlap), "MOL", target,
            overlap, seam_passes=n - 1, noise=noise_f)
    assert torch.equal(gs.concat_folds(y, target, overlap, total), seq[0])


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_v2_kernel_matches_plain(cuda, mode):
    """B10 at 3 rows x 500 steps against its plain version: float32
    weights and streams within 2e-3 (summation order only); bfloat16
    weights and streams, at least 99 % of samples within 1e-3 of the plain
    version at the same roundings; the counter hash from a seed."""
    from wavernn_tpu_torch.ops import cuda_gen2
    voc, gen = _small_voc(mode, cuda, 23)
    core = voc.core_weights()
    B, T = 3, 500
    mu = torch.rand(B, T, 80, generator=gen).to(cuda)
    au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
    NC = core["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    u = cuda_gen.counter_uniforms(9, T, B, nu, mode == "MOL", cuda)
    noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
    f32, bf16 = torch.float32, torch.bfloat16
    with torch.no_grad():
        before = cuda_gen2.generate_v2.launches
        got = cuda_gen2.generate_v2(core, mu, au, mode, noise=noise,
                                    compute_dtype=f32, stream_dtype=f32)
        assert cuda_gen2.generate_v2.launches == before + 1
        want = cuda_gen2.generate_v2_ref(core, mu, au, mode, noise=noise,
                                         stream_dtype=f32)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
        got = cuda_gen2.generate_v2(core, mu, au, mode, noise=noise)
        want = cuda_gen2.generate_v2_ref(core, mu, au, mode, noise=noise,
                                         compute_dtype=bf16)
        share = float(((got - want).abs() <= 1e-3).float().mean())
        assert share >= 0.99, share
        got = cuda_gen2.generate_v2(core, mu, au, mode, seed=31,
                                    compute_dtype=f32, stream_dtype=f32)
        want = cuda_gen2.generate_v2_ref(core, mu, au, mode, seed=31,
                                         stream_dtype=f32)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def _resident_case(mode, cuda, seed, rnn, fc):
    gen = torch.Generator().manual_seed(seed)
    voc = wr.WaveRNN(WaveRNNConfig(mode=mode, rnn_dims=rnn, fc_dims=fc,
                                   compute_dims=16, res_out_dims=32,
                                   res_blocks=1), DSPConfig())
    voc.reset_parameters(gen)
    return voc.to(cuda).eval().core_weights(), gen


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_resident_fused_equals_legacy_body(cuda, mode, dtype):
    """B1 and B4b on the resident body against the original body's dense arm,
    bit for bit: rnn 256 (one or two units a block on the card's SMs), fc
    128 (some blocks own no fc unit), 10 rows in more than one 8-row tile
    of the old body, injected noise and the counter hash; B4b from a given
    state with a snapshot inside, chained at a chunk boundary. The routing
    counts: the resident body's launches, none of the old dense arm's
    unless asked for."""
    core, gen = _resident_case(mode, cuda, 31, 256, 128)
    B, chunks, c1, hop, K = 10, 4, 2, 275, 5
    frames = torch.rand(chunks + K - 1, B, 80 + 32, generator=gen).to(cuda)
    phi = torch.rand(K, hop, generator=gen).to(cuda)
    T, T1 = chunks * hop, c1 * hop
    NC = core["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    u = cuda_gen.counter_uniforms(7, T, B, nu, mode == "MOL", cuda)
    noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
    cut = (lambda n, a, b: tuple(v[a:b] for v in n) if mode == "MOL"
           else n[a:b])
    state = tuple(t.to(cuda) for t in (torch.rand(B, 256, generator=gen) - .5,
                                       torch.rand(B, 256, generator=gen) - .5,
                                       torch.rand(B, generator=gen) - .5))
    args = (core, frames, phi, hop, 2, chunks, mode)
    kw = dict(compute_dtype=dtype)
    with torch.no_grad():
        before = (cuda_gen.generate_fused.resident_launches,
                  cuda_gen.generate_fused.legacy_launches)
        for nz in ({"noise": noise}, {"seed": 11}):
            new = cuda_gen.generate_fused(*args, **nz, **kw)
            old = cuda_gen.generate_fused(*args, **nz, **kw, _legacy=True)
            assert torch.equal(new, old), nz.keys()
        assert (cuda_gen.generate_fused.resident_launches,
                cuda_gen.generate_fused.legacy_launches) == (
                    before[0] + 2, before[1] + 2)
        skw = dict(noise=noise, init_state=state, state_snapshot_at=700, **kw)
        new = cuda_gen.generate_fused_with_state(*args, **skw)
        old = cuda_gen.generate_fused_with_state(*args, **skw, _legacy=True)
        assert torch.equal(new[0], old[0]) and _same(new[1], old[1])
        y, st = cuda_gen.generate_fused_with_state(
            *args, noise=noise, init_state=state, **kw)
        y1, st1 = cuda_gen.generate_fused_with_state(
            core, frames[:c1 + K - 1].contiguous(), phi, hop, 2, c1, mode,
            noise=cut(noise, 0, T1), init_state=state, **kw)
        y2, st2 = cuda_gen.generate_fused_with_state(
            core, frames[c1:].contiguous(), phi, hop, 2, chunks - c1, mode,
            noise=cut(noise, T1, T), init_state=st1, **kw)
        _, snap = cuda_gen.generate_fused_with_state(
            *args, noise=noise, init_state=state, state_snapshot_at=T1, **kw)
        old = cuda_gen.generate_fused_with_state(
            *args, noise=noise, init_state=state, **kw, _legacy=True)
    assert torch.equal(y, old[0]) and _same(st, old[1])
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and _same(st2, st)
    assert _same(snap, st1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_resident_materialized_equals_legacy_body(cuda, mode, dtype):
    """B3 with B4a on the resident body against the original body's dense
    arm, bit for bit, at the same narrow widths: 3 rows x 300 steps from a
    given state with a snapshot inside, injected noise and the counter
    hash; two chained launches of 150 equal one."""
    core, gen = _resident_case(mode, cuda, 32, 256, 128)
    B, T, T1 = 3, 300, 150
    mu = torch.rand(B, T, 80, generator=gen).to(cuda)
    au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
    NC = core["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    u = cuda_gen.counter_uniforms(8, T, B, nu, mode == "MOL", cuda)
    noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
    cut = (lambda n, a, b: tuple(v[a:b] for v in n) if mode == "MOL"
           else n[a:b])
    state = tuple(t.to(cuda) for t in (torch.rand(B, 256, generator=gen) - .5,
                                       torch.rand(B, 256, generator=gen) - .5,
                                       torch.rand(B, generator=gen) - .5))
    kw = dict(compute_dtype=dtype)
    with torch.no_grad():
        for nz in ({"noise": noise}, {"seed": 12}):
            skw = dict(init_state=state, state_snapshot_at=100, **nz, **kw)
            new = cuda_gen.generate_materialized(core, mu, au, mode, **skw)
            old = cuda_gen.generate_materialized(core, mu, au, mode, **skw,
                                                 _legacy=True)
            assert torch.equal(new[0], old[0]) and _same(new[1], old[1])
        y, st = cuda_gen.generate_materialized(core, mu, au, mode,
                                               noise=noise, **kw)
        y1, st1 = cuda_gen.generate_materialized(
            core, mu[:, :T1], au[:, :T1], mode, noise=cut(noise, 0, T1), **kw)
        y2, st2 = cuda_gen.generate_materialized(
            core, mu[:, T1:], au[:, T1:], mode, noise=cut(noise, T1, T),
            init_state=st1, **kw)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and _same(st2, st)


@pytest.mark.parametrize("rows,dtype", [(128, torch.bfloat16),
                                        (128, torch.float32),
                                        (500, torch.bfloat16)])
def test_resident_many_rows_equals_legacy_body(cuda, rows, dtype):
    """Past 64 rows at the default rnn and fc widths (512), bit for bit
    against the original body's dense arm: B1 over two hop chunks (bench
    .py's 128 folds; 500 rows, several a sampling block) and B3 with B4a
    from a given state with a snapshot inside, under the counter hash. In
    float32 at 128 rows and at 500 the plan keeps the per-row regions in
    device memory, in bfloat16 at 128 in shared memory."""
    core, gen = _resident_case("MOL", cuda, 33, 512, 512)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = cuda_gen.resident_plan(512, 512, 30, 8, 80, rows, sms, dtype, 5)
    assert plan.rows_global == (rows == 500 or dtype == torch.float32)
    chunks, hop, K = 2, 275, 5
    frames = torch.rand(chunks + K - 1, rows, 80 + 32,
                        generator=gen).to(cuda)
    phi = torch.rand(K, hop, generator=gen).to(cuda)
    args = (core, frames, phi, hop, 2, chunks, "MOL")
    T = 120
    mu = torch.rand(rows, T, 80, generator=gen).to(cuda)
    au = (torch.rand(rows, T, 32, generator=gen) * 2 - 1).to(cuda)
    state = tuple(t.to(cuda) for t in (
        torch.rand(rows, 512, generator=gen) - .5,
        torch.rand(rows, 512, generator=gen) - .5,
        torch.rand(rows, generator=gen) - .5))
    skw = dict(seed=14, init_state=state, state_snapshot_at=50,
               compute_dtype=dtype)
    with torch.no_grad():
        new = cuda_gen.generate_fused(*args, seed=13, compute_dtype=dtype)
        old = cuda_gen.generate_fused(*args, seed=13, compute_dtype=dtype,
                                      _legacy=True)
        new3 = cuda_gen.generate_materialized(core, mu, au, "MOL", **skw)
        old3 = cuda_gen.generate_materialized(core, mu, au, "MOL", **skw,
                                              _legacy=True)
    assert torch.equal(new, old)
    assert torch.equal(new3[0], old3[0]) and _same(new3[1], old3[1])


def _pruned_case(mode, cuda, seed, rnn, fc, block=(128, 128)):
    core, gen = _resident_case(mode, cuda, seed, rnn, fc)
    params = {k: v for k, v in core.items() if k in cuda_gen._PACK_SOURCES}
    core = dict(core)
    g = torch.Generator().manual_seed(seed)
    for k, w in params.items():   # a random 1 in 16 of each matrix's blocks
        O, I = w.shape
        keep = torch.rand(O // block[0], -(-I // block[1]), generator=g) \
            < 1 / 16
        keep[0, 0] = True
        m = keep.repeat_interleave(block[0], 0).repeat_interleave(
            block[1], 1)[:, :I].to(cuda)
        core[k] = w * m
    return core, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_resident_sparse_equals_legacy_body(cuda, mode, dtype):
    """B9 on the resident body against the original body's sparse arm and
    the resident dense arm on the same masked weights, bit for bit, at a
    narrow model (rnn 256, fc 128: some blocks own no fc unit, so their
    done words carry the step): B1 at 1 and 10 rows under injected noise
    and the counter hash, B3 with B4a from a state with a snapshot inside,
    chained launches equal to one; the routing counts."""
    core, gen = _pruned_case(mode, cuda, 41, 256, 128)
    pack = cuda_gen.pack_sparse(core)
    assert pack.entries
    chunks, hop, K = 3, 275, 5
    phi = torch.rand(K, hop, generator=gen).to(cuda)
    NC = core["fc3.weight"].shape[0]
    nu = NC // 3 + 1 if mode == "MOL" else NC
    kw = dict(compute_dtype=dtype, sparse_packed=pack)
    with torch.no_grad():
        for B in (1, 10):
            frames = torch.rand(chunks + K - 1, B, 80 + 32,
                                generator=gen).to(cuda)
            T = chunks * hop
            u = cuda_gen.counter_uniforms(B, T, B, nu, mode == "MOL", cuda)
            noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
            args = (core, frames, phi, hop, 2, chunks, mode)
            for nz in ({"noise": noise}, {"seed": 15}):
                n0 = (cuda_gen.generate_fused.sparse_launches,
                      cuda_gen.generate_fused.legacy_sparse_launches)
                new = cuda_gen.generate_fused(*args, **nz, **kw)
                old = cuda_gen.generate_fused(*args, **nz, **kw, _legacy=True)
                dense = cuda_gen.generate_fused(*args, **nz,
                                                compute_dtype=dtype)
                assert (cuda_gen.generate_fused.sparse_launches,
                        cuda_gen.generate_fused.legacy_sparse_launches) == (
                            n0[0] + 1, n0[1] + 1)
                assert torch.equal(new, old) and torch.equal(new, dense), B
        B, T, T1 = 3, 300, 150
        mu = torch.rand(B, T, 80, generator=gen).to(cuda)
        au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
        state = tuple(t.to(cuda) for t in (
            torch.rand(B, 256, generator=gen) - .5,
            torch.rand(B, 256, generator=gen) - .5,
            torch.rand(B, generator=gen) - .5))
        skw = dict(seed=16, init_state=state, state_snapshot_at=100, **kw)
        new = cuda_gen.generate_materialized(core, mu, au, mode, **skw)
        old = cuda_gen.generate_materialized(core, mu, au, mode, **skw,
                                             _legacy=True)
        assert _same(new, old)
        u = cuda_gen.counter_uniforms(8, T, B, nu, mode == "MOL", cuda)
        noise = (u[..., :nu - 1], u[..., nu - 1]) if mode == "MOL" else u
        cut = (lambda n, a, b: tuple(v[a:b] for v in n) if mode == "MOL"
               else n[a:b])
        y, st = cuda_gen.generate_materialized(core, mu, au, mode,
                                               noise=noise, **kw)
        y1, st1 = cuda_gen.generate_materialized(
            core, mu[:, :T1], au[:, :T1], mode, noise=cut(noise, 0, T1), **kw)
        y2, st2 = cuda_gen.generate_materialized(
            core, mu[:, T1:], au[:, T1:], mode, noise=cut(noise, T1, T),
            init_state=st1, **kw)
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and _same(st2, st)


@pytest.mark.parametrize("rows,dtype", [(128, torch.bfloat16),
                                        (128, torch.float32),
                                        (500, torch.bfloat16)])
def test_resident_sparse_many_rows_equals_legacy_body(cuda, rows, dtype):
    """B9 past 64 rows at rnn and fc 512 (several tiles of rows: each block
    reads xr and x2 as written, its own units' columns with its live
    chunks'; at 500 rows the per-row regions in device memory), bit for
    bit against the original body's sparse arm: B1 over two hop chunks and
    B3 from a given state, under the counter hash."""
    core, gen = _pruned_case("MOL", cuda, 42, 512, 512)
    pack = cuda_gen.pack_sparse(core)
    chunks, hop, K = 2, 275, 5
    frames = torch.rand(chunks + K - 1, rows, 80 + 32, generator=gen).to(cuda)
    phi = torch.rand(K, hop, generator=gen).to(cuda)
    args = (core, frames, phi, hop, 2, chunks, "MOL")
    T = 100
    mu = torch.rand(rows, T, 80, generator=gen).to(cuda)
    au = (torch.rand(rows, T, 32, generator=gen) * 2 - 1).to(cuda)
    state = tuple(t.to(cuda) for t in (
        torch.rand(rows, 512, generator=gen) - .5,
        torch.rand(rows, 512, generator=gen) - .5,
        torch.rand(rows, generator=gen) - .5))
    kw = dict(compute_dtype=dtype, sparse_packed=pack)
    with torch.no_grad():
        new = cuda_gen.generate_fused(*args, seed=17, **kw)
        old = cuda_gen.generate_fused(*args, seed=17, **kw, _legacy=True)
        skw = dict(seed=18, init_state=state, state_snapshot_at=40, **kw)
        new3 = cuda_gen.generate_materialized(core, mu, au, "MOL", **skw)
        old3 = cuda_gen.generate_materialized(core, mu, au, "MOL", **skw,
                                              _legacy=True)
    assert torch.equal(new, old)
    assert _same(new3, old3)


@pytest.mark.parametrize("sdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_resident_v2_equals_legacy_body(cuda, mode, sdtype):
    """B10 on the resident body against the original body's arm, bit for
    bit, both stream dtypes, MOL and RAW: at the narrow model (rnn 256, fc
    128) at 1 and 10 rows under injected noise and the counter hash, and
    at rnn and fc 512 over 200 rows (the per-row regions in device memory
    in float32, the streams read in place); the routing counts."""
    from wavernn_tpu_torch.ops import cuda_gen2
    for rnn, fc, rows in ((256, 128, (1, 10)), (512, 512, (200,))):
        core, gen = _resident_case(mode, cuda, 43, rnn, fc)
        NC = core["fc3.weight"].shape[0]
        nu = NC // 3 + 1 if mode == "MOL" else NC
        with torch.no_grad():
            for B in rows:
                T = 400
                mu = torch.rand(B, T, 80, generator=gen).to(cuda)
                au = (torch.rand(B, T, 32, generator=gen) * 2 - 1).to(cuda)
                u = cuda_gen.counter_uniforms(B, T, B, nu, mode == "MOL",
                                              cuda)
                noise = (u[..., :nu - 1], u[..., nu - 1]) \
                    if mode == "MOL" else u
                for dt in (torch.float32, torch.bfloat16):
                    for nz in ({"noise": noise}, {"seed": 19}):
                        kw = dict(compute_dtype=dt, stream_dtype=sdtype, **nz)
                        n0 = (cuda_gen2.generate_v2.resident_launches,
                              cuda_gen2.generate_v2.legacy_launches)
                        new = cuda_gen2.generate_v2(core, mu, au, mode, **kw)
                        old = cuda_gen2.generate_v2(core, mu, au, mode, **kw,
                                                    _legacy=True)
                        assert (cuda_gen2.generate_v2.resident_launches,
                                cuda_gen2.generate_v2.legacy_launches) == (
                                    n0[0] + 1, n0[1] + 1)
                        assert torch.equal(new, old), (rnn, B, dt)
