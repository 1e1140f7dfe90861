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
