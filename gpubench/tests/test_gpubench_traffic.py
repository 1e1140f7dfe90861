"""The traffic generator: deterministic under a seed, and the same work
under every seed."""
import json

import pytest

from gpubench import harness, traffic

SEEDS = (0, 1, 7, 2 ** 31 + 17, 5_000_000_123)


def load(mix):
    return json.loads((harness.HERE / "workloads" / f"{mix}.json")
                      .read_text())


@pytest.mark.parametrize("mix", ["tts_batch", "tts_single"])
def test_serving_calls_repeat_under_a_seed(mix):
    m = load(mix)
    assert traffic.tts_calls(m, 11, 2) == traffic.tts_calls(m, 11, 2)
    assert traffic.tts_calls(m, 11, 2) != traffic.tts_calls(m, 12, 2)


@pytest.mark.parametrize("mix", ["tts_batch", "tts_single"])
def test_serving_work_is_the_same_under_every_seed(mix):
    from wavernn_tpu_torch.text import text_to_sequence
    m = load(mix)
    works = set()
    for seed in SEEDS:
        calls = traffic.tts_calls(m, seed, 2)
        assert sorted(len(t) for c in calls for t in c["texts"]) == sorted(
            m["lengths"])
        for c in calls:
            for t in c["texts"]:
                # one symbol id a character through the port's cleaners
                assert len(text_to_sequence(t, ["english_cleaners"])) == len(t)
        works.add(tuple(sorted(
            (c["steps"], tuple(sorted(map(len, c["texts"])))) for c in calls)))
    assert len(works) == 1


def test_training_batches_are_the_same_shapes_under_every_seed():
    m = load("train_af")
    shapes = set()
    for seed in SEEDS:
        batches = traffic.train_items(m, seed, 2)
        shapes.add(tuple(sorted(
            (mf, tuple((len(t), mel.shape, a.shape) for t, mel, a in items))
            for mf, items in batches)))
        for _, items in batches:
            for _, mel, a in items:
                assert 0.0 <= mel.min() and mel.max() <= 1.0
                assert abs(a.sum(axis=1) - 1).max() < 1e-5
    assert len(shapes) == 1
    one = traffic.train_items(m, 3, 2)
    two = traffic.train_items(m, 3, 2)
    assert all((a[1][0][1] == b[1][0][1]).all() for a, b in zip(one, two))


def test_training_batches_pad_as_the_trainers_collate():
    """The benchmark's own padding of a training batch (which both the
    program and the reference read) is what the port's trainer would feed
    from the same items."""
    import numpy as np
    from wavernn_tpu_torch.data.dataset import collate_tts
    from wavernn_tpu_torch.text import text_to_sequence
    from gpubench.reference.tacotron import text_ids
    m = dict(load("train_af"), max_frames=[40, 61], spread=[1.0, 0.8, 0.55])
    for r in (2, 3):
        for _, items in traffic.train_items(m, 5, r):
            ids, mel, aref = traffic.collate(items, r, text_ids)
            rows = [(text_to_sequence(t, ["english_cleaners"]), x, f"i{i}",
                     x.shape[-1], a) for i, (t, x, a) in enumerate(items)]
            want = collate_tts(rows, r, offline_attn=True)
            assert ids.dtype == want[0].dtype and mel.dtype == want[1].dtype
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(mel, want[1])
            np.testing.assert_array_equal(aref, want[4])


def _voc_cfg():
    return json.loads((harness.HERE / "configs" / "lj_mol.json").read_text())


def test_vocoder_batches_are_the_same_shapes_under_every_seed():
    m, cfg = load("train_voc"), dict(_voc_cfg(), voc_batch_size=4)
    shapes = set()
    for seed in SEEDS:
        items = traffic.voc_items(m, seed, cfg)
        shapes.add(tuple((mel.shape, q.shape) for b in items for mel, q in b))
        for b in items:
            for mel, q in b:
                assert 0.0 <= mel.min() and mel.max() <= 1.0
                assert 0 <= q.min() and q.max() < 2 ** 16
        x, y, mels = traffic.collate_voc(items[0], 275, 1375, 2, 16, "MOL",
                                         traffic.crop_rng(seed))
        assert x.shape == y.shape == (4, 1375) and mels.shape == (4, 80, 9)
    assert len(shapes) == 1
    one, two = (traffic.voc_items(m, 3, cfg)[1][2][1] for _ in range(2))
    assert (one == two).all()


@pytest.mark.parametrize("mode", ["MOL", "RAW"])
def test_vocoder_batches_cut_as_the_trainers_collate(mode):
    """The benchmark's own cut of a vocoder batch (which both the program
    and the reference read) is what the port's trainer would feed from the
    same utterances and the same crop generator."""
    import dataclasses
    import numpy as np
    from wavernn_tpu_torch.config import Config
    from wavernn_tpu_torch.data.dataset import collate_vocoder
    cfg = dict(_voc_cfg(), voc_batch_size=6, voc_mode=mode)
    port = Config()
    port = dataclasses.replace(port, voc=dataclasses.replace(port.voc,
                                                             mode=mode))
    assert (port.dsp.hop_length, port.voc_train.seq_len, port.voc.pad,
            port.dsp.bits) == (cfg["hop_length"], cfg["voc_seq_len"],
                               cfg["voc_pad"], cfg["bits"])
    bits = 16 if mode == "MOL" else cfg["bits"]
    for seed in (5, 2 ** 31 + 17):
        for items in traffic.voc_items(load("train_voc"), seed, cfg):
            got = traffic.collate_voc(items, cfg["hop_length"],
                                      cfg["voc_seq_len"], cfg["voc_pad"],
                                      bits, mode, traffic.crop_rng(seed))
            want = collate_vocoder(items, port, traffic.crop_rng(seed))
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
