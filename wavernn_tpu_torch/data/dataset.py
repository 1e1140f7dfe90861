"""Vocoder input pipeline (port of the vocoder half of
``wavernn_tpu.data.dataset``; reference utils/dataset.py), numpy only.

The same on-disk artifacts as the reference pipeline
(``data/{mel,quant,gta,gta_<id>}/<item>.npy`` and ``dataset.pkl``) and the
same crop and scale:

  * collate: a random mel window of ``seq_len//hop + 2*voc_pad`` frames,
    the signal cropped at ``(mel_off + pad) * hop``, ``seq_len + 1``
    labels -> x = labels[:-1] as floats (16-bit scale for MOL), y =
    labels[1:] (floats only for MOL)  (dataset.py:72-98);
  * a deterministic split: a seed-1234 shuffle, the last
    ``voc_test_samples`` held out  (dataset.py:47-51).
"""
from __future__ import annotations

import pickle
import random
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..config import Config
from ..dsp.audio import label_2_float


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


class VocoderBatcher:
    """Shuffled epoch iterator yielding (x, y, mels) numpy batches; the
    last partial batch is dropped."""

    def __init__(self, dataset: VocoderDataset, cfg: Config, batch_size: int,
                 seed: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        self.epoch += 1
        order = rng.permutation(len(self.dataset))
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            items = [self.dataset[j] for j in order[i:i + bs]]
            yield collate_vocoder(items, self.cfg, rng)


def get_vocoder_datasets(path: Path, batch_size: int, cfg: Config,
                         train_gta: bool = False, tts_model_id: str = "",
                         seed: int = 0):
    """(train_batcher, test_dataset) (dataset.py:40-69)."""
    train_ids, test_ids = vocoder_split(path, cfg.voc_train.test_samples)
    train = VocoderDataset(path, train_ids, train_gta, tts_model_id)
    test = VocoderDataset(path, test_ids, train_gta, tts_model_id)
    return VocoderBatcher(train, cfg, batch_size, seed), test
