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
float32: mel, scores, the residual streams and every gradient within 1e-5
of each tensor's largest entry (summation order only, over at most 7
groups); a Tacotron train step's loss and gradients on the card within
1e-4 of the CPU's (the whole model, other library kernels). The
attention-forcing recurrence (B7), float32: mel, scores, the streams,
d(aref) and every gradient within 1e-5 of each tensor's largest entry, as
B6; an AF-offline train step with the kernels within 1e-5 (loss, relative)
and 1e-4 (each gradient of its largest entry) of the same step with
``recurrence="scan"`` on the card.
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


@pytest.mark.parametrize("B,T,G,r,train", [(5, 33, 7, 2, True),
                                           (3, 20, 6, 5, False)])
def test_taco_af_kernels_match_plain(cuda, B, T, G, r, train):
    ins, w = _b7_inputs(B, T, G, r, cuda, train)
    with torch.no_grad():
        before = ct.decoder_af.fwd_launches
        mel, sc, st = ct.decoder_af_fwd(*ins, w, save=True)
        mel_p, sc_p, st_p = ct.core_af_ref(*ins, *w, save=True)
        assert ct.decoder_af.fwd_launches == before + 1
        assert _rel(mel, mel_p) <= 1e-5 and _rel(sc, sc_p) <= 1e-5
        for k in ct.AF_STREAMS:
            assert _rel(st[k], st_p[k]) <= 1e-5, k
        gen = torch.Generator().manual_seed(1)
        dmel = torch.randn(mel.shape, generator=gen).to(cuda)
        dsc = torch.randn(sc.shape, generator=gen).to(cuda)
        before = ct.decoder_af.bwd_launches
        got = ct.decoder_af_bwd(dmel, dsc, st, sc, *ins, w)
        want = ct.core_af_bwd_ref(dmel, dsc, st, sc, *ins, *w)
        torch.cuda.synchronize()
        assert ct.decoder_af.bwd_launches == before + 1
    names = ("daref", "denc", "dencp") + ct.AF_WEIGHTS
    assert len(got) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5, name


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
        loss, _, _, _, g = tt.loss_and_grads_af(
            copy.deepcopy(model), x, m, aref, r, 200.0, True, rec, masks)
        assert ct.decoder_af.bwd_launches == before + (rec == "auto")
        out[rec] = (float(loss), g)
    (lk, gk), (ls, gs) = out["auto"], out["scan"]
    assert abs(lk - ls) <= 1e-5 * abs(ls)
    for a, b in zip(gk, gs):
        assert _rel(a, b) <= 1e-4
