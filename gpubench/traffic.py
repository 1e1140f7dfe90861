"""The one general traffic generator: it reads a mix's data file from
``workloads/`` and makes, from the run's seed, the texts, the order and
the seeds of every request or training batch.

Every seed asks for the same work: the lengths are a fixed list in the
mix's file, and the seed only permutes them and picks which words of the
frozen corpus (``text/``, a copy of the repository's test sentences) fill
each length.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# characters the corpus keeps: each maps to one symbol id through the
# port's english_cleaners, so a text of L characters is L ids for every
# seed
_KEEP = re.compile(r"[^a-z .,'-]")


def corpus() -> str:
    """The frozen sentences, lower-cased, cut to the kept characters and
    joined by single spaces."""
    lines = []
    for path in sorted((HERE / "text").glob("*.txt")):
        lines += [ln.strip() for ln in path.read_text().splitlines()
                  if ln.strip()]
    text = _KEEP.sub(" ", " ".join(lines).lower())
    return re.sub(" +", " ", text).strip()


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    return np.random.default_rng([seed % (2 ** 63), stream])


def cut(text: str, length: int, gen: np.random.Generator) -> str:
    """``length`` characters of ``text`` (wrapping round), starting at a
    word and ending on a character that is not a space, at a place drawn
    from ``gen``."""
    loop = text + " " + text
    while len(loop) < 2 * length + len(text):
        loop += " " + text
    starts = [i for i in range(len(text))
              if (i == 0 or loop[i - 1] == " ") and loop[i] != " "
              and loop[i + length - 1] != " "]
    o = starts[int(gen.integers(len(starts)))]
    return loop[o:o + length]


def decode_frames(length: int, frames_per_char: float, r: int) -> int:
    """The decode bound of a text of ``length`` characters: its frames at
    the speaking rate, rounded up to a multiple of r."""
    return -(-math.ceil(frames_per_char * length) // r) * r


def tts_calls(mix: dict, seed: int, r: int):
    """One pass of a serving mix as calls: each a dict with ``texts`` and
    ``steps`` (the decode bound, the longest text's). ``batch`` > 1 sorts
    the pass by length and cuts it into batches, as a bulk job bins its
    sentences, then shuffles the batches; ``batch`` 1 shuffles the
    sentences."""
    text = corpus()
    g = rng(seed, 0)
    lengths = list(mix["lengths"])
    texts = [cut(text, n, g) for n in lengths]
    b = mix["batch"]
    if b > 1:
        order = sorted(range(len(texts)), key=lambda i: (lengths[i], i))
        groups = [order[i:i + b] for i in range(0, len(order), b)]
    else:
        groups = [[i] for i in range(len(texts))]
    perm = rng(seed, 1).permutation(len(groups))
    calls = []
    for k in perm:
        idx = groups[k]
        calls.append({"texts": [texts[i] for i in idx],
                      "steps": max(decode_frames(lengths[i],
                                                 mix["frames_per_char"], r)
                                   for i in idx)})
    return calls


def call_seed(seed: int, index: int) -> int:
    """The seed of the sampling noise of the run's ``index``-th call."""
    return int(rng(seed, 1000 + index).integers(2 ** 62))


def train_items(mix: dict, seed: int, r: int):
    """The training batches of a mix, in the mix's order, which the run
    cycles (the seed makes their data, not their order: an order drawn
    from the seed moved the step rate by up to 7 % from seed to seed):
    a list of (max_frames, items); each item (text, mel (n_mels, frames)
    float32 in [0, 1], attention reference (groups, chars) float32 whose
    rows sum to 1). Within a batch the frames spread below its longest by
    the mix's ``spread``; each text has the characters of its frames at
    the speaking rate."""
    text = corpus()
    n_mels = mix["num_mels"]
    g = rng(seed, 2)
    batches = []
    for mf in mix["max_frames"]:
        items = []
        for q in mix["spread"]:
            frames = int(round(mf * q))
            chars = max(2, int(round(frames / mix["frames_per_char"])))
            mel = g.random((n_mels, frames), dtype=np.float32)
            items.append((cut(text, chars, g), mel,
                          alignment(frames, chars, r, mix["attn_width"])))
        batches.append((mf, items))
    return batches


def alignment(frames: int, chars: int, r: int, width: float) -> np.ndarray:
    """A monotone attention reference, (groups, chars): a Gaussian bump of
    ``width`` characters moving evenly over the text, each row normalised
    to 1: the shape of a teacher's exported attention."""
    groups = -(-(frames + 1) // r)
    c = (np.arange(groups) + 0.5) / groups * chars - 0.5
    t = np.arange(chars)
    a = np.exp(-0.5 * ((t[None, :] - c[:, None]) / width) ** 2)
    return (a / a.sum(axis=1, keepdims=True)).astype(np.float32)


def collate(items, r: int, ids):
    """A training batch from ``train_items``' items, padded as the
    upstream dataset's collate pads it: the symbol ids (``ids(text)``)
    with 0 to the longest text; the mels scaled from [0, 1] to [-4, 4]
    and padded with 0 (before the scaling) to the longest mel + 1, rounded
    up to a multiple of r; each attention reference given zero columns
    before its last up to the longest text, and its last row repeated up
    to the mel's groups. Returns (ids (B, T) int64, mel (B, n_mels,
    frames) float32, aref (B, frames / r, T) float32)."""
    seqs = [ids(text) for text, _, _ in items]
    T = max(len(q) for q in seqs)
    F = max(mel.shape[-1] for _, mel, _ in items) + 1
    F = -(-F // r) * r
    chars = np.zeros((len(items), T), np.int64)
    mels = np.zeros((len(items), items[0][1].shape[0], F), np.float32)
    aref = np.zeros((len(items), F // r, T), np.float32)
    for b, (q, (_, mel, a)) in enumerate(zip(seqs, items)):
        chars[b, :len(q)] = q
        mels[b, :, :mel.shape[-1]] = mel
        g, c = a.shape
        aref[b, :g, :c - 1] = a[:, :-1]
        aref[b, :g, T - 1] = a[:, -1]
        aref[b, g:] = aref[b, g - 1]
    return chars, mels * 8.0 - 4.0, aref
