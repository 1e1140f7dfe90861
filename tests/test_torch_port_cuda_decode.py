"""CUDA tier: the resident decode body (csrc/taco_decode_resident.cu, kernels
B2 and B8) against the plain versions and the original body
(csrc/taco_decode.cu, ``_legacy=True``) on the card. Marked ``cuda``; each
test skips where torch sees no CUDA device. On a GPU machine without JAX,
skip the suite's conftest (it imports JAX):

    PYTHONPATH=. python -m pytest tests/test_torch_port_cuda_decode.py -m cuda -q --noconftest

Tolerance (float32 on both sides, summation order only, TF32 off): mel
2e-3, attention 2e-4, every row's stop group identical; a stopped row's
later groups equal its frozen-state group bit for bit. Shapes: a narrow
decoder (LSTMs 64) and the full default widths, with no stop and with a
forced stop (rows stopping at different groups where the batch has them).
"""
import pytest
import torch

from wavernn_tpu_torch.config import TacotronConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.ops import cuda_taco as ctd

pytestmark = pytest.mark.cuda

MEL_TOL, ATT_TOL = 2e-3, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc at "
                    "first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, width, lens, seed):
    gen = torch.Generator().manual_seed(seed)
    cfg = (TacotronConfig(embed_dims=32, encoder_K=2, lstm_dims=64,
                          postnet_dims=32, postnet_K=2, num_highways=1)
           if width == "narrow" else TacotronConfig())
    tts = taco.Tacotron(cfg, 80)
    tts.reset_parameters(gen)
    tts = tts.to(cuda).eval()
    seqs = [torch.randint(1, 148, (n,), generator=gen).tolist() for n in lens]
    ids, lens_t = taco.pad_ids(seqs, cuda)
    with torch.no_grad():
        enc = tts.encoder(ids, lens=lens_t)
        mask = (torch.arange(ids.shape[1], device=cuda)[None]
                < lens_t[:, None]).float()
        enc = enc * mask[..., None]
        encp = (enc @ tts.encoder_proj.weight.t()) * mask[..., None]
    return tts.decoder_weights(), enc, encp, mask


def _check(got, want):
    (mel_k, att_k, nv_k), (mel_p, att_p, nv_p) = got, want
    assert torch.equal(nv_k, nv_p)
    torch.testing.assert_close(mel_k, mel_p, atol=MEL_TOL, rtol=0)
    torch.testing.assert_close(att_k, att_p, atol=ATT_TOL, rtol=0)
    r = mel_k.shape[2] // att_k.shape[1]
    for b, n in enumerate(nv_k.tolist()):   # the frozen replay
        if n < att_k.shape[1]:
            assert torch.equal(mel_k[b, :, n * r:(n + 1) * r],
                               mel_k[b, :, -r:])


def _counts():
    return (ctd.decode.launches, ctd.decode.legacy_launches,
            ctd.decode_batch.launches, ctd.decode_batch.legacy_launches)


@pytest.mark.parametrize("width", ["narrow", "full"])
@pytest.mark.parametrize("threshold", [-1e30, 10.0])
def test_one_row_on_the_resident_body(cuda, width, threshold):
    dec, enc, encp, mask = _inputs(cuda, width, [42], 1)
    args = (dec, enc, encp, mask[0], 2, 80, 80, 20, threshold)
    before = _counts()
    with torch.no_grad():
        got = ctd.decode(*args)
        assert _counts() == (before[0] + 1,) + before[1:]
        old = ctd.decode(*args, _legacy=True)
        assert _counts()[:2] == (before[0] + 1, before[1] + 1)
        want = ctd.decode_ref(*args)
    _check(got, want)
    _check(old, want)
    assert int(got[2][0]) == (7 if threshold > 0 else 40)


@pytest.mark.parametrize("width", ["narrow", "full"])
def test_batch_on_the_resident_body_with_stops(cuda, width):
    lens = [5, 17, 43, 30, 9, 40, 22, 12, 33]
    dec, enc, encp, mask = _inputs(cuda, width, lens, 2)
    tail = (2, 120, 80, 20)
    with torch.no_grad():
        free = ctd.decode_batch_ref(dec, enc, encp, mask, *tail, -1e30)[0]
    # a threshold between two rows' group maxima after group 5
    peaks = free.reshape(len(lens), 80, 60, 2).amax(dim=(1, 3))[:, 6:]
    vals = peaks.flatten().sort().values
    thr = float((vals[len(vals) // 2] + vals[len(vals) // 2 + 1]) / 2)
    before = _counts()
    for t in (-1e30, thr):
        with torch.no_grad():
            got = ctd.decode_batch(dec, enc, encp, mask, *tail, t)
            want = ctd.decode_batch_ref(dec, enc, encp, mask, *tail, t)
            old = ctd.decode_batch(dec, enc, encp, mask, *tail, t,
                                   _legacy=True)
        _check(got, want)
        _check(old, want)
    assert _counts() == (before[0], before[1], before[2] + 2, before[3] + 2)
