"""CUDA tier: the port's hand-written kernels against their plain
versions on the card, at small widths. Marked ``cuda``; each test skips
where torch sees no CUDA device. On a GPU machine without JAX, skip the
suite's conftest (it imports JAX):

    PYTHONPATH=. python -m pytest tests/test_torch_port_cuda.py -m cuda -q --noconftest

Tolerance: 2e-3 on samples and mels (float32 on both sides, summation
order only; TF32 off), attention 2e-4, the stop group identical.
"""
import pytest
import torch

from wavernn_tpu_torch.config import (DSPConfig, TacotronConfig,
                                      WaveRNNConfig)
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen, cuda_taco

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
