"""Port parity, block-sparse serving (B9's plain version): the packing
(``ops/cuda_gen.pack_sparse``), the block-sparse product
(``sparse_mm_ref``) and every generation entry point's ``sparse_packed=``
against the JAX package on the CPU.

Weights: JAX ``init_wavernn`` at rnn and fc 256 (every gate split holds
2 x 2 blocks of (128, 128)), pruned by the JAX package's own masks, then
the port's weight bridge. Noise: the same numpy uniforms on both sides.

Tolerances: the packs agree exactly (which matrices pack, their live
blocks); ``sparse_mm_ref`` matches JAX ``_sparse_mm`` within 1e-5 of the
largest entry (float32, the two sum in different orders); the sparse
generation paths match the JAX ``generate`` scan on the same masked
weights within 2e-3, the bound tests/test_torch_port_serve_voc.py holds
the dense paths to (the JAX package's own tests hold its sparse kernels
to that scan, tests/test_pallas_sparse.py); streamed samples equal the
offline sparse run exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  the CPU-thread budget

from wavernn_tpu.config import DSPConfig as JDSP
from wavernn_tpu.config import WaveRNNConfig as JVoc
from wavernn_tpu.models import wavernn as jwr
from wavernn_tpu.ops import pallas_gen as jpg
from wavernn_tpu.ops.fold import num_folds_for
from wavernn_tpu.train import pruning as jpr
from wavernn_tpu.train.checkpoints import tree_to_flat
from wavernn_tpu_torch.compat.from_jax import state_dict_from_jax
from wavernn_tpu_torch.config import Config, DSPConfig, WaveRNNConfig
from wavernn_tpu_torch.models import wavernn as wr
from wavernn_tpu_torch.ops import cuda_gen
from wavernn_tpu_torch.streaming import MultiStreamVocoder, StreamingVocoder

VOC = dict(rnn_dims=256, fc_dims=256, compute_dims=16, res_out_dims=16,
           res_blocks=1)
HOP = 275
Z = 0.9375
TARGET, OVERLAP = 4 * HOP, HOP


def _pruned(mode, seed=1, block=(128, 128), z=Z, rnn_input=True):
    """JAX parameters pruned by the JAX package's masks, and the port's
    model on the same weights."""
    jvoc = JVoc(mode=mode, **VOC)
    params = jwr.init_wavernn(jax.random.PRNGKey(seed), jvoc, JDSP())
    spec = jpr.wavernn_prune_spec(rnn_input)
    params = jpr.apply_masks(params, jpr.update_masks(
        params, None, jnp.asarray(100), spec, 0, 100, z, block), spec)
    model = wr.WaveRNN(WaveRNNConfig(mode=mode, **VOC), DSPConfig())
    model.load_state_dict(state_dict_from_jax(tree_to_flat(params),
                                              Config()), strict=True)
    return jvoc, params, model.eval()


def _noise(rng, T, B):
    return (rng.uniform(1e-5, 1 - 1e-5, (T, B, 10)).astype(np.float32),
            rng.uniform(1e-5, 1 - 1e-5, (T, B)).astype(np.float32))


def _t(noise):
    return tuple(torch.from_numpy(u) for u in noise)


def _j(noise):
    return tuple(jnp.asarray(u) for u in noise)


@pytest.mark.parametrize("block,z,allow_br8,rnn_input", [
    ((128, 128), Z, False, True), ((128, 128), 0.75, False, False),
    ((8, 128), Z, True, True), ((8, 128), Z, False, True)])
def test_pack_equals_jax(block, z, allow_br8, rnn_input):
    """Which matrices pack and their live blocks, on (128, 128) masks at
    two targets (without the input matrices pruned, wi1 and wi2x stay
    dense), and on (8, 128) masks, which pack only under allow_br8."""
    jvoc, params, model = _pruned("MOL", 2, block, z, rnn_input)
    pack = cuda_gen.pack_sparse(model.core_weights(), model.voc,
                                allow_br8=allow_br8)
    static, arrays = jpg.pack_sparse(params, jvoc, allow_br8=allow_br8)
    assert sorted(pack.entries) == sorted(n for n, _, _ in static)
    for (name, br, rows), packed in zip(static, arrays):
        m = pack.entries[name]
        assert (m.br, m.rows) == (br, rows), name
        assert m.blocks.shape[0] == max(m.live(), 0)
    if block == (8, 128) and not allow_br8:
        assert not pack.entries
    if not rnn_input:
        assert "wi1" not in pack.entries and "wi2x" not in pack.entries


def test_pack_dense_fallbacks_equal_jax():
    ones = np.ones((384, 128), np.float32)          # JAX (in, out)
    assert jpg._pack_block_sparse(ones, br=128) is None
    assert cuda_gen._pack_block_sparse(torch.from_numpy(ones.T)) is None
    # three of four (128, 128) blocks live: more than half, stays dense
    w = np.ones((256, 256), np.float32)
    w[:128, :128] = 0
    assert jpg._pack_block_sparse(w, br=128) is None
    assert cuda_gen._pack_block_sparse(torch.from_numpy(w.T)) is None
    # two of four live: packs; a fully pruned output block gives 0
    w[:128, 128:] = 0
    _, rows = jpg._pack_block_sparse(w, br=128)
    m = cuda_gen._pack_block_sparse(torch.from_numpy(w.T.copy()))
    assert m.rows == rows == ((1,), (1,))
    w[:, 128:] = 0
    m = cuda_gen._pack_block_sparse(torch.from_numpy(w.T.copy()))
    assert m.rows == ((1,), ())
    y = cuda_gen.sparse_mm_ref(torch.ones(3, 256), m)
    assert not y[:, 128:].any() and bool((y[:, :128] == 128.0).all())
    # ragged shapes do not tile
    assert cuda_gen._pack_block_sparse(torch.zeros(256, 260)) is None


@pytest.mark.parametrize("allow_br8,block", [(False, (128, 128)),
                                             (True, (8, 128))])
def test_sparse_mm_ref_matches_jax(allow_br8, block):
    jvoc, params, model = _pruned("RAW", 3, block)
    pack = cuda_gen.pack_sparse(model.core_weights(), model.voc,
                                allow_br8=allow_br8)
    static, arrays = jpg.pack_sparse(params, jvoc, allow_br8=allow_br8)
    assert static
    rng = np.random.RandomState(0)
    for (name, br, rows), packed in zip(static, arrays):
        I = pack.entries[name].shape[1]
        op = rng.uniform(-1, 1, (5, I)).astype(np.float32)
        want = np.asarray(jpg._sparse_mm(jnp.asarray(op), packed, rows, br))
        got = cuda_gen.sparse_mm_ref(torch.from_numpy(op), pack.entries[name])
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode,batched", [("MOL", False), ("MOL", True),
                                          ("RAW", True)])
def test_generate_sparse_matches_jax_scan(mode, batched):
    """``generate(sparse_packed=)``: batched with target and overlap hop
    multiples (B1's plain version) and unbatched (B3's), against the JAX
    scan on the same masked weights."""
    jvoc, params, model = _pruned(mode, 4)
    pack = cuda_gen.pack_sparse(model.core_weights(), model.voc)
    assert len(pack.entries) == 6
    rng = np.random.RandomState(1)
    n_frames = 22    # the wave outlasts the 20-frame fade
    mels = rng.uniform(0, 1, (1, 80, n_frames)).astype(np.float32)
    B = num_folds_for(n_frames * HOP, TARGET, OVERLAP) if batched else 1
    T = TARGET + 2 * OVERLAP if batched else n_frames * HOP
    if mode == "MOL":
        noise = _noise(rng, T, B)
    else:
        noise = (rng.uniform(1e-5, 1 - 1e-5, (T, B, 512)).astype(np.float32),)
    want = jwr.generate(params, mels, jvoc, JDSP(), jax.random.PRNGKey(0),
                        batched=batched, target=TARGET, overlap=OVERLAP,
                        use_pallas=False,
                        noise=_j(noise) if mode == "MOL" else
                        jnp.asarray(noise[0]))
    got = wr.generate(model, mels, batched=batched, target=TARGET,
                      overlap=OVERLAP, device="cpu", sparse_packed=pack,
                      noise=_t(noise) if mode == "MOL" else
                      torch.from_numpy(noise[0]))
    assert got.shape == want.shape == ((n_frames - 1) * HOP,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_generate_fast_and_multi_sparse_match_jax_scan():
    jvoc, params, model = _pruned("MOL", 5)
    core = model.core_weights()
    pack = cuda_gen.pack_sparse(core, model.voc)
    rng = np.random.RandomState(2)
    mels = [rng.uniform(0, 1, (1, 80, n)).astype(np.float32)
            for n in (22, 25)]
    counts = [num_folds_for(m.shape[-1] * HOP, TARGET, OVERLAP)
              for m in mels]
    noise = _noise(rng, TARGET + 2 * OVERLAP, sum(counts))
    cols = [slice(0, counts[0]), slice(counts[0], sum(counts))]
    wants = [jwr.generate(params, m, jvoc, JDSP(), jax.random.PRNGKey(0),
                          target=TARGET, overlap=OVERLAP, use_pallas=False,
                          noise=tuple(jnp.asarray(u[:, c]) for u in noise))
             for m, c in zip(mels, cols)]
    fast = wr.generate_fast(model, mels[0], target=TARGET, overlap=OVERLAP,
                            device="cpu", sparse_packed=pack,
                            noise=tuple(torch.from_numpy(u[:, cols[0]])
                                        for u in noise))
    assert fast.dtype == torch.float32
    np.testing.assert_allclose(fast.numpy(), wants[0], atol=2e-3)
    outs = wr.generate_multi(model, mels, target=TARGET, overlap=OVERLAP,
                             device="cpu", sparse_packed=pack,
                             noise=_t(noise))
    for got, want in zip(outs, wants):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3)
    # an empty pack serves dense: the same samples as no pack at all
    dense_pack = cuda_gen.pack_sparse(
        wr.WaveRNN(model.voc, model.dsp).core_weights())
    assert not dense_pack.entries
    a = wr.generate_fast(model, mels[0], target=TARGET, overlap=OVERLAP,
                         device="cpu", sparse_packed=dense_pack,
                         noise=tuple(torch.from_numpy(u[:, cols[0]])
                                     for u in noise))
    b = wr.generate_fast(model, mels[0], target=TARGET, overlap=OVERLAP,
                         device="cpu", noise=tuple(torch.from_numpy(
                             u[:, cols[0]]) for u in noise))
    assert torch.equal(a, b)
    # a pack made before the weights changed in place is refused
    with torch.no_grad():
        model.fc2.weight.mul_(1.0)
    with pytest.raises(ValueError, match="stale"):
        wr.generate_fast(model, mels[0], target=TARGET, overlap=OVERLAP,
                         device="cpu", sparse_packed=pack)
    assert cuda_gen.pack_sparse(model.core_weights(), model.voc) is not pack


def test_streaming_sparse_equals_offline_and_jax_scan():
    """StreamingVocoder on B3's sparse plain version: exactly the offline
    sparse run; within 2e-3 of the JAX scan on the masked weights. A
    MultiStreamVocoder lane equals its solo stream."""
    jvoc, params, model = _pruned("MOL", 6)
    pack = cuda_gen.pack_sparse(model.core_weights(), model.voc)
    rng = np.random.RandomState(3)
    frames = 16
    mels = rng.uniform(0.2, 0.8, (80, frames)).astype(np.float32)
    T = frames * HOP
    noise = _noise(rng, T, 1)
    sv = StreamingVocoder(model, chunk_frames=7, mu_law=False,
                          noise=_t(noise), device="cpu", sparse_packed=pack)
    got = np.concatenate([sv.feed(mels[:, :9]), sv.feed(mels[:, 9:]),
                          sv.flush()])
    m = torch.nn.functional.pad(torch.from_numpy(mels)[None], (2, 2))
    with torch.no_grad():
        mu, au = model.upsample(m)
        off, _ = cuda_gen.generate_materialized_ref(
            model.core_weights(), mu, au, "MOL", noise=_t(noise),
            sparse_packed=pack)
    np.testing.assert_array_equal(got, off[0].numpy())
    from wavernn_tpu import streaming as jstream
    jsv = jstream.StreamingVocoder(params, jvoc, JDSP(),
                                   jax.random.PRNGKey(0), chunk_frames=7,
                                   mu_law=False, use_pallas=False,
                                   noise=_j(noise))
    jgot = np.concatenate([jsv.feed(mels), jsv.flush()])
    np.testing.assert_allclose(got, jgot, atol=2e-3)
    msv = MultiStreamVocoder(model, 2, chunk_frames=7, noise=tuple(
        torch.from_numpy(np.concatenate([u, u], axis=1)) for u in noise),
        device="cpu", sparse_packed=pack)
    lanes = [[], []]
    for b in (0, 1):
        for sb, y in msv.feed(b, mels).items():
            lanes[sb].append(y)
    for b in (0, 1):
        for sb, y in msv.flush(b).items():
            lanes[sb].append(y)
    for b in (0, 1):
        np.testing.assert_allclose(np.concatenate(lanes[b]), got,
                                   atol=1e-5)
