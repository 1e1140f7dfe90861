"""Dataset preprocessing (reference preprocess.py; port of
``wavernn_tpu.data.preprocess``).

wav -> (mel .npy, quant .npy) + dataset.pkl [(id, n_frames)] +
text_dict.pkl, over a process pool of files. Host numpy on purpose: the
artifacts are the bytes the JAX package writes, so either package trains
on the other's dataset.
"""
from __future__ import annotations

import pickle
from multiprocessing import Pool, cpu_count
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..config import Config
from ..dsp.audio import encode_mu_law, float_2_label, load_wav
from ..dsp.mel import melspectrogram_np
from ..text.recipes import ljspeech

_CFG: Config = None  # set per worker by the Pool initializer


def _init_worker(cfg: Config):
    global _CFG
    _CFG = cfg


def convert_file(path: Path, cfg: Config = None):
    """wav -> (mel float32 (num_mels, T), quant int64)
    (preprocess.py:36-47)."""
    cfg = cfg or _CFG
    y = load_wav(path, cfg.dsp.sample_rate)
    peak = np.abs(y).max()
    if cfg.dsp.peak_norm or peak > 1.0:
        y = y / peak
    mel = melspectrogram_np(y, cfg.dsp)
    if cfg.voc.mode == "RAW":
        quant = (encode_mu_law(y, mu=2 ** cfg.dsp.bits) if cfg.dsp.mu_law
                 else float_2_label(y, bits=cfg.dsp.bits))
    elif cfg.voc.mode == "MOL":
        quant = float_2_label(y, bits=16)
    else:
        raise ValueError(cfg.voc.mode)
    return mel.astype(np.float32), quant.astype(np.int64)


def _process_wav(args):
    path, mel_dir, quant_dir = args
    wav_id = Path(path).stem
    m, x = convert_file(Path(path))
    np.save(Path(mel_dir) / f"{wav_id}.npy", m, allow_pickle=False)
    np.save(Path(quant_dir) / f"{wav_id}.npy", x, allow_pickle=False)
    return wav_id, m.shape[-1]


def get_files(path, extension=".wav") -> List[Path]:
    return sorted(Path(path).expanduser().rglob(f"*{extension}"))


def preprocess(cfg: Config, workspace, wav_path=None, extension=".wav",
               n_workers: int = None, log=print) -> List[Tuple[str, int]]:
    """Run the whole preprocessing pipeline; returns the dataset manifest,
    in the order the workers finished."""
    wav_path = Path(wav_path or cfg.wav_path)
    wav_files = get_files(wav_path, extension)
    log(f"{len(wav_files)} {extension[1:]} files found in {wav_path}")
    if not wav_files:
        return []

    if not cfg.ignore_tts:
        # metadata.csv lives in the wav dir's PARENT (preprocess.py:73)
        text_dict = ljspeech(wav_path.parent)
        with open(workspace.data / "text_dict.pkl", "wb") as f:
            pickle.dump(text_dict, f)

    n_workers = max(1, n_workers or (cpu_count() - 1))
    jobs = [(str(p), str(workspace.mel), str(workspace.quant))
            for p in wav_files]
    dataset: List[Tuple[str, int]] = []
    with Pool(processes=n_workers, initializer=_init_worker,
              initargs=(cfg,)) as pool:
        for i, item in enumerate(pool.imap_unordered(_process_wav, jobs), 1):
            dataset.append(item)
            if i % 50 == 0 or i == len(jobs):
                log(f"{i}/{len(jobs)}")

    with open(workspace.data / "dataset.pkl", "wb") as f:
        pickle.dump(dataset, f)
    return dataset
