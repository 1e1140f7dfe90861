"""CUDA tier, multi-device: the counter hash's global rows in the sample
loops (``row0`` / ``B_global``), a one-rank NCCL ``DeviceMesh`` through
``generate_sharded``, and a Tacotron step on a shard's strided dropout and
zoneout masks (B6's backward reads them as rows), on the card. Marked
``cuda``; each test skips where torch sees no CUDA device. On a GPU
machine without JAX, skip the suite's conftest (it imports JAX):

    PYTHONPATH=. python -m pytest tests/test_torch_port_cuda_mesh.py -m cuda -q --noconftest

The sample loops bit for bit: a launch on a slice of the fold batch, its
hash counters offset to the slice's rows, draws the whole launch's
numbers, and the resident body's per-row sums do not depend on the row
count. The Tacotron step: the loss and every gradient within 1e-5 of each
one's largest entry (cuDNN's convolution backward may sum in another
order from one run to the next); the strided masks read as rows moved
the decoder's gradients by up to 13 % of their largest entries.
"""
import os
import socket

import pytest
import torch

from wavernn_tpu_torch.config import DSPConfig, TacotronConfig, WaveRNNConfig
from wavernn_tpu_torch.models import tacotron as taco
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc at "
                    "first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _vocoder(dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    voc = wr.WaveRNN(WaveRNNConfig(rnn_dims=64, fc_dims=64, compute_dims=16,
                                   res_out_dims=32, res_blocks=1),
                     DSPConfig())
    voc.reset_parameters(gen)
    mels = torch.rand(1, 80, 30, generator=gen)
    return voc.to(dev).eval(), mels.to(dev)


@pytest.mark.parametrize("rows", [(0, 5), (5, 5), (3, 4), (9, 1)])
def test_sample_loops_on_a_slice_equal_rows_of_the_full_launch(cuda, rows):
    """B1, B4b and B3 on folds [row0, row0 + B) of 10, with the hash's rows
    set to theirs, equal those rows of the launch over all 10."""
    row0, B = rows
    voc, mels = _vocoder(cuda)
    core = voc.core_weights()
    with torch.no_grad():
        frames, phi, geo, chunks = wr.fused_conditioning(
            voc, torch.nn.functional.pad(mels, (2, 2)), 30 * 275, 550, 275)
        assert frames.shape[1] == 10
        tail = (phi, geo.hop, -geo.d_lo, chunks, "MOL")
        part = frames[:, row0:row0 + B].contiguous()
        rk = {"row0": row0, "B_global": 10}
        full = cuda_gen.generate_fused(core, frames, *tail, seed=3)
        got = cuda_gen.generate_fused(core, part, *tail, seed=3, **rk)
        assert torch.equal(got, full[row0:row0 + B])
        snap = dict(seed=3, state_snapshot_at=825)
        full_s, st = cuda_gen.generate_fused_with_state(core, frames, *tail,
                                                        **snap)
        got_s, st_p = cuda_gen.generate_fused_with_state(core, part, *tail,
                                                         **snap, **rk)
        assert torch.equal(got_s, full_s[row0:row0 + B])
        for a, b in zip(st_p, st):
            assert torch.equal(a, b[row0:row0 + B])
        mu, au = voc.upsample(torch.nn.functional.pad(mels, (2, 2)))
        mu = mu.reshape(10, -1, mu.shape[-1])[:, :800].contiguous()
        au = au.reshape(10, -1, au.shape[-1])[:, :800].contiguous()
        full_m, _ = cuda_gen.generate_materialized(core, mu, au, "MOL",
                                                   seed=4)
        got_m, _ = cuda_gen.generate_materialized(
            core, mu[row0:row0 + B].contiguous(),
            au[row0:row0 + B].contiguous(), "MOL", seed=4, **rk)
        assert torch.equal(got_m, full_m[row0:row0 + B])
        with pytest.raises(ValueError, match="original sample-loop body"):
            cuda_gen.generate_fused(core, part, *tail, seed=3, _legacy=True,
                                    **rk)


def test_one_rank_mesh_generate_sharded_equals_one_device(cuda):
    """A one-rank NCCL DeviceMesh through both modes of generate_sharded:
    bit for bit the one-device call with the same seed."""
    import torch.distributed as dist
    from wavernn_tpu_torch.parallel import gen_sharded as gs
    from wavernn_tpu_torch.parallel.mesh import make_mesh
    voc, mels = _vocoder(cuda, seed=1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("nccl", rank=0, world_size=1, device_id=cuda)
    try:
        mesh = make_mesh()
        for passes in (0, 2):
            kw = dict(target=550, overlap=275, seam_passes=passes,
                      device=cuda, device_out=True)
            got = gs.generate_sharded(voc, mels, mesh=mesh,
                                      generator=torch.Generator()
                                      .manual_seed(5), **kw)
            want = gs.generate_sharded(voc, mels,
                                       generator=torch.Generator()
                                       .manual_seed(5), **kw)
            assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_tacotron_step_on_strided_masks_equals_contiguous(cuda):
    """A shard's masks, sliced from the whole batch's on the batch axis
    (``train/tacotron_train.rank_masks``), are strided; B6 forward and
    backward read them as rows. The step's loss and every gradient equal
    the same step on contiguous copies."""
    from wavernn_tpu_torch.train import tacotron_train as tt
    gen = torch.Generator().manual_seed(2)
    tts = taco.Tacotron(TacotronConfig(embed_dims=32, encoder_K=2,
                                       lstm_dims=64, postnet_dims=32,
                                       postnet_K=2, num_highways=1), 80)
    tts.reset_parameters(gen)
    tts = tts.to(cuda)
    B, T_text, G, r = 8, 20, 5, 2
    ids = torch.randint(1, 148, (B, T_text), generator=gen).to(cuda)
    m = (torch.rand(B, 80, G * r, generator=gen) * 8 - 4).to(cuda)
    masks = taco.draw_masks(tts, B, T_text, G,
                            torch.Generator(device=cuda).manual_seed(3),
                            cuda)
    rows = slice(2, 6)
    strided = {k: v[rows] if k.startswith("enc") else v[:, rows]
               for k, v in masks.items()}
    assert not strided["zm1"].is_contiguous()
    dense = {k: v.contiguous() for k, v in strided.items()}
    got = tt.loss_and_grads(tts, ids[rows], m[rows], r, masks=strided)
    want = tt.loss_and_grads(tts, ids[rows], m[rows], r, masks=dense)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
