"""Vocoder and TTS input pipelines (port of ``wavernn_tpu.data.dataset``;
reference utils/dataset.py), numpy only.

The same on-disk artifacts as the reference pipeline
(``data/{mel,quant,gta,gta_<id>}/<item>.npy`` and ``dataset.pkl``) and the
same crop and scale:

  * collate: a random mel window of ``seq_len//hop + 2*voc_pad`` frames,
    the signal cropped at ``(mel_off + pad) * hop``, ``seq_len + 1``
    labels -> x = labels[:-1] as floats (16-bit scale for MOL), y =
    labels[1:] (floats only for MOL)  (dataset.py:72-98);
  * a deterministic split: a seed-1234 shuffle, the last
    ``voc_test_samples`` held out  (dataset.py:47-51);
  * TTS: text ids and mels padded to the batch's longest (the mel to its
    longest + 1, rounded up to r), mels scaled [0, 1] -> [-4, 4], and the
    reference's length-binned, seeded batch order (dataset.py:106-263).
"""
from __future__ import annotations

import pickle
import random
import warnings
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..config import Config
from ..dsp.audio import label_2_float
from ..text import text_to_sequence


class VocoderDataset:
    """(mel, quant) pairs by item id (dataset.py:20-37)."""

    def __init__(self, path: Path, dataset_ids: Sequence[str],
                 train_gta: bool = False, tts_model_id: str = ""):
        self.metadata = list(dataset_ids)
        path = Path(path)
        self.mel_path = path / "gta" if train_gta else path / "mel"
        if train_gta and tts_model_id:
            self.mel_path = path / f"gta_{tts_model_id}"
        self.quant_path = path / "quant"

    def __getitem__(self, index: int):
        item_id = self.metadata[index]
        m = np.load(self.mel_path / f"{item_id}.npy")
        x = np.load(self.quant_path / f"{item_id}.npy")
        return m, x

    def __len__(self):
        return len(self.metadata)


def load_dataset_ids(path: Path) -> List[Tuple[str, int]]:
    with open(Path(path) / "dataset.pkl", "rb") as f:
        return pickle.load(f)


def vocoder_split(path: Path, test_samples: int):
    """Deterministic train/test id split (dataset.py:45-51)."""
    dataset_ids = [x[0] for x in load_dataset_ids(path)]
    rnd = random.Random(1234)
    rnd.shuffle(dataset_ids)
    return dataset_ids[:-test_samples], dataset_ids[-test_samples:]


def collate_vocoder(batch, cfg: Config, rng: np.random.RandomState):
    """Random-crop collate (dataset.py:72-98). Returns (x, y, mels)."""
    hop = cfg.dsp.hop_length
    seq_len = cfg.voc_train.seq_len
    pad = cfg.voc.pad
    mel_win = seq_len // hop + 2 * pad
    max_offsets = [m.shape[-1] - 2 - (mel_win + 2 * pad) for m, _ in batch]
    mel_offsets = [rng.randint(0, off) for off in max_offsets]
    sig_offsets = [(off + pad) * hop for off in mel_offsets]

    mels = np.stack([m[:, mo:mo + mel_win]
                     for (m, _), mo in zip(batch, mel_offsets)]
                    ).astype(np.float32)
    labels = np.stack([q[so:so + seq_len + 1]
                       for (_, q), so in zip(batch, sig_offsets)]
                      ).astype(np.int64)

    x = labels[:, :seq_len]
    y = labels[:, 1:]
    bits = 16 if cfg.voc.mode == "MOL" else cfg.dsp.bits
    x = label_2_float(x.astype(np.float32), bits)
    if cfg.voc.mode == "MOL":
        y = label_2_float(y.astype(np.float32), bits)
    return x, y, mels


def _shard_slice(batch_size: int, num_shards: int, shard_index: int):
    """The contiguous rows of a global batch that shard ``shard_index`` of
    ``num_shards`` keeps; the batch must divide evenly."""
    if batch_size % num_shards or not 0 <= shard_index < num_shards:
        raise ValueError(f"batch size {batch_size} over {num_shards} shards "
                         f"(shard {shard_index}): the batch must divide "
                         "evenly")
    per = batch_size // num_shards
    return slice(shard_index * per, (shard_index + 1) * per)


class VocoderBatcher:
    """Shuffled epoch iterator yielding (x, y, mels) numpy batches; the
    last partial batch is dropped.

    With (num_shards, shard_index) each rank keeps its contiguous slice of
    every batch (wavernn_tpu/data/dataset.py:100-133): the global batch is
    collated with the epoch's one rng (the random crops included), then
    sliced, so every shard is the JAX package's bit for bit and every
    rank's shapes are equal."""

    def __init__(self, dataset: VocoderDataset, cfg: Config, batch_size: int,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.shard = _shard_slice(batch_size, num_shards, shard_index)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(len(self.dataset))
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            items = [self.dataset[j] for j in order[i:i + bs]]
            x, y, m = collate_vocoder(items, self.cfg, rng)
            yield x[self.shard], y[self.shard], m[self.shard]


def get_vocoder_datasets(path: Path, batch_size: int, cfg: Config,
                         train_gta: bool = False, tts_model_id: str = "",
                         seed: int = 0, num_shards: int = 1,
                         shard_index: int = 0):
    """(train_batcher, test_dataset) (dataset.py:40-69); ``num_shards`` /
    ``shard_index`` as in ``VocoderBatcher``."""
    train_ids, test_ids = vocoder_split(path, cfg.voc_train.test_samples)
    train = VocoderDataset(path, train_ids, train_gta, tts_model_id)
    test = VocoderDataset(path, test_ids, train_gta, tts_model_id)
    return (VocoderBatcher(train, cfg, batch_size, seed, num_shards,
                           shard_index), test)


# --------------------------------------------------------------------------
# TTS dataset
# --------------------------------------------------------------------------

class TTSDataset:
    """(text ids, mel, item id, mel length[, attn_ref]) by item id
    (dataset.py:146-164)."""

    def __init__(self, path: Path, dataset_ids: Sequence[str], text_dict,
                 cfg: Config):
        self.path = Path(path)
        self.metadata = list(dataset_ids)
        self.text_dict = text_dict
        self.cfg = cfg

    def __getitem__(self, index: int):
        item_id = self.metadata[index]
        x = text_to_sequence(self.text_dict[item_id],
                             self.cfg.tts.cleaner_names)
        mel = np.load(self.path / "mel" / f"{item_id}.npy")
        mel_len = mel.shape[-1]
        if self.cfg.tts.mode == "attention_forcing_offline":
            attn_ref = np.load(self.path / self.cfg.tts_train.attn_ref_path
                               / f"{item_id}.npy")
            return x, mel, item_id, mel_len, attn_ref
        return x, mel, item_id, mel_len

    def __len__(self):
        return len(self.metadata)


def pad1d(x, max_len):
    return np.pad(x, (0, max_len - len(x)))


def pad2d(x, max_len):
    return np.pad(x, ((0, 0), (0, max_len - x.shape[-1])))


def pad_cut_attn(attn, max_x_len, max_attn_len):
    """Pad or cut an attention-reference map to the batch's dimensions,
    moving cut mass onto the last kept position (dataset.py:175-196)."""
    l_a, l_x = attn.shape
    attn_pad = attn
    if max_x_len - l_x < 0:
        if max_x_len < 0.5 * l_x:
            warnings.warn(f"max_x_len {max_x_len} < 0.5 * l_x {l_x}")
        tmp = attn_pad[:, -(1 + l_x - max_x_len):-1].sum(axis=1, keepdims=True) \
            / max_x_len
        attn_pad = np.delete(attn, np.s_[-(1 + l_x - max_x_len):-1], axis=1)
        attn_pad = attn_pad + tmp
    elif max_x_len - l_x > 0:
        tmp = np.zeros([max_x_len - l_x, 1])
        attn_pad = np.insert(attn, -1, tmp, axis=1)
    if max_attn_len - l_a < 0:
        if max_attn_len < 0.5 * l_a:
            warnings.warn(f"max_attn_len {max_attn_len} < 0.5 * l_a {l_a}")
        attn_pad = attn_pad[:max_attn_len]
    elif max_attn_len - l_a > 0:
        tmp = np.tile(attn_pad[-1, :], (max_attn_len - l_a, 1))
        attn_pad = np.concatenate([attn_pad, tmp], axis=0)
    return attn_pad


def collate_tts(batch, r: int, offline_attn: bool = False):
    """Pad and scale (dataset.py:199-231): (chars (B, T_text) int64, mel
    (B, n_mels, steps) float32 in [-4, 4], ids, mel_lens[, attn_ref]);
    steps is the longest mel + 1, rounded up to a multiple of r."""
    x_lens = [len(b[0]) for b in batch]
    max_x_len = max(x_lens)
    chars = np.stack([pad1d(b[0], max_x_len) for b in batch]).astype(np.int64)

    spec_lens = [b[1].shape[-1] for b in batch]
    max_spec_len = max(spec_lens) + 1
    if max_spec_len % r != 0:
        max_spec_len += r - max_spec_len % r
    mel = np.stack([pad2d(b[1], max_spec_len) for b in batch]).astype(np.float32)
    mel = (mel * 8.0) - 4.0  # [0,1] -> [-4,4] (dataset.py:222)

    ids = [b[2] for b in batch]
    mel_lens = [b[3] for b in batch]
    if offline_attn:
        attn_ref = np.stack([pad_cut_attn(b[4], max_x_len, max_spec_len // r)
                             for b in batch]).astype(np.float32)
        return chars, mel, ids, mel_lens, attn_ref
    return chars, mel, ids, mel_lens


def binned_length_order(lengths: Sequence[int], batch_size: int,
                        bin_size: int, rnd: random.Random) -> np.ndarray:
    """BinnedLengthSampler order (dataset.py:234-263): indices sorted by
    length, shuffled within bins of ``bin_size``, the remainder last."""
    assert bin_size % batch_size == 0
    idx = np.argsort(np.asarray(lengths))
    bins = []
    for i in range(len(idx) // bin_size):
        this_bin = idx[i * bin_size:(i + 1) * bin_size].copy()
        rnd.shuffle(this_bin)
        bins.append(this_bin)
    binned_idx = (np.stack(bins).reshape(-1) if bins
                  else np.empty((0,), np.int64))
    if len(binned_idx) < len(idx):
        last_bin = idx[len(binned_idx):].copy()
        rnd.shuffle(last_bin)
        binned_idx = np.concatenate([binned_idx, last_bin])
    return binned_idx


class TTSBatcher:
    """Epoch iterator over collated TTS batches with length binning; the
    last partial batch is dropped. (num_shards, shard_index) as in
    ``VocoderBatcher``: the global batch is padded to its longest item,
    then sliced, so the loss means over each rank's equal shapes average
    to the global batch's."""

    def __init__(self, dataset: TTSDataset, lengths: Sequence[int],
                 batch_size: int, r: int, bin_lengths: bool = True,
                 seed: int = 0, offline_attn: bool = False,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.r = r
        self.bin_lengths = bin_lengths
        self.seed = seed
        self.epoch = 0
        self.offline_attn = offline_attn
        self.shard = _shard_slice(batch_size, num_shards, shard_index)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        rnd = random.Random(self.seed + self.epoch)
        self.epoch += 1
        if self.bin_lengths:
            order = binned_length_order(self.lengths, self.batch_size,
                                        self.batch_size * 3, rnd)
        else:
            order = np.asarray(
                rnd.sample(range(len(self.dataset)), len(self.dataset)))
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            items = [self.dataset[j] for j in order[i:i + bs]]
            yield tuple(f[self.shard] for f in collate_tts(
                items, self.r, self.offline_attn))


def get_tts_datasets(path: Path, batch_size: int, r: int, cfg: Config,
                     seed: int = 0, num_shards: int = 1,
                     shard_index: int = 0):
    """(train_batcher, attn_example): items longer than ``max_mel_len``
    are left out; attn_example is the longest item's id
    (dataset.py:106-143); ``num_shards`` / ``shard_index`` as in
    ``TTSBatcher``."""
    dataset = load_dataset_ids(path)
    dataset_ids, mel_lengths = [], []
    for item_id, n in dataset:
        if cfg.tts_train.max_mel_len is None or n <= cfg.tts_train.max_mel_len:
            dataset_ids.append(item_id)
            mel_lengths.append(n)
    with open(Path(path) / "text_dict.pkl", "rb") as f:
        text_dict = pickle.load(f)
    ds = TTSDataset(path, dataset_ids, text_dict, cfg)
    offline = cfg.tts.mode == "attention_forcing_offline"
    batcher = TTSBatcher(ds, mel_lengths, batch_size, r,
                         cfg.tts_train.bin_lengths, seed, offline,
                         num_shards, shard_index)
    attn_example = dataset_ids[int(np.argmax(mel_lengths))]
    return batcher, attn_example
