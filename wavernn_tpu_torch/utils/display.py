"""Console and plot output (reference utils/display.py; port of
``wavernn_tpu.utils.display``).

``save_attention`` and ``save_spectrogram`` write their PNG with the
standard library alone (zlib, struct): the array is min-max scaled to 8
bits and stored as indices into a fixed 256-entry colour table (viridis),
one pixel per entry, in the JAX package's orientation. Axes and figure
size are not drawn. ``plot`` and ``plot_spec`` are interactive helpers and
import matplotlib when called.
"""
from __future__ import annotations

import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np

# viridis at 256 levels, 8-bit RGB (matplotlib's table, public domain)
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e614710"
    "6347116447136548146748166848176948186a481a6c481b6d481c6e481d6f48"
    "1f70482071482173482374482475482576482677482878482979472a7a472c7a"
    "472d7b472e7c472f7d46307e46327e46337f4634804535814537814538824439"
    "83443a83443b84433d84433e85423f8542408642418641428741448740458840"
    "46883f47883f48893e49893e4a893e4c8a3d4d8a3d4e8a3c4f8a3c508b3b518b"
    "3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d365c8d365d"
    "8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e31678e31"
    "688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c"
    "8e287d8e277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24"
    "868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d"
    "21918c20928c20928c20938c1f948c1f958b1f968b1f978b1f988b1f998a1f9a"
    "8a1e9b8a1e9c891e9d891f9e891f9f881fa0881fa1881fa1871fa28720a38620"
    "a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad81"
    "28ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b7"
    "7937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf7046c06f48"
    "c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d0"
    "5477d1537ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590"
    "d74393d74195d84098d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32"
    "addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e0"
    "20cae11fcde11dd0e11cd2e21bd5e21ad8e219dae319dde318dfe318e2e418e5"
    "e419e7e419eae51aece51befe51cf1e51df4e61ef6e620f8e621fbe723fde725")
PALETTE = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)


def stream(message: str):
    """Carriage-return status line (display.py:9)."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def progbar(i, n, size: int = 16) -> str:
    done = (i * size) // max(n, 1)
    return "\u2588" * done + "\u2591" * (size - done)


def simple_table(item_tuples):
    """Boxed config table (display.py:21-69)."""
    border_pattern = "+---------------------------------------"
    headings, cells = [], []
    for item in item_tuples:
        heading, cell = str(item[0]), str(item[1])
        pad_head = True
        while len(heading) < len(cell):
            heading += " " if pad_head else ""
            heading = " " + heading if pad_head else heading
            pad_head = not pad_head
        while len(cell) < len(heading):
            cell += " "
        headings.append(heading)
        cells.append(cell)
    border, head, body = "", "", ""
    for i in range(len(item_tuples)):
        pad = " " if i > 0 else ""
        head += pad + headings[i] + " |"
        body += pad + cells[i] + " |"
        border += border_pattern[: len(headings[i]) + 2] + "+"
    print(border, f"|{head}", border, f"|{body}", border, sep="\n")
    print(" ")


def time_since(started) -> str:
    elapsed = time.time() - started
    m = int(elapsed // 60)
    s = int(elapsed % 60)
    if m >= 60:
        h = int(m // 60)
        m = m % 60
        return f"{h}h {m}m {s}s"
    return f"{m}m {s}s"


def _host(a) -> np.ndarray:
    """A numpy float64 copy of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def to_indices(M) -> np.ndarray:
    """A 2-D array min-max scaled to uint8 colour-table indices (a constant
    array maps to 0; NaN counts as 0)."""
    M = np.nan_to_num(np.atleast_2d(_host(M)))
    lo, hi = float(M.min()), float(M.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return np.rint((M - lo) * scale).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(M, path) -> Path:
    """Write a 2-D array as an 8-bit palette PNG at ``path``: row 0 at the
    top, one pixel per entry, colours from ``PALETTE``."""
    idx = to_indices(M)
    h, w = idx.shape
    if h == 0 or w == 0:
        raise ValueError(f"cannot write an empty image {idx.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), idx], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
           + _chunk(b"PLTE", PALETTE.tobytes())
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png)
    return path


def save_attention(attn, path):
    """Attention map (decoder steps, text positions) -> ``{path}.png``,
    transposed as the reference shows it: text positions down, decoder
    steps across (display.py:84-90)."""
    return write_png(_host(attn).T, f"{path}.png")


def save_spectrogram(M, path, length=None):
    """Spectrogram (bins, frames) -> ``{path}.png``, the highest bin on
    top, cut to ``length`` frames."""
    M = np.flip(_host(M), axis=0)
    if length:
        M = M[:, :length]
    return write_png(M, f"{path}.png")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot(array, path=None):
    """Interactive waveform/curve plot for notebooks
    (reference utils/display.py:100-111). Shows the figure when a GUI
    backend is live; pass ``path`` to save a png instead (headless)."""
    plt = _plt()
    fig = plt.figure(figsize=(30, 5))
    ax = fig.add_subplot(111)
    for axis in (ax.xaxis, ax.yaxis):
        axis.label.set_color("grey")
        axis.label.set_fontsize(23)
    ax.tick_params(axis="x", colors="grey", labelsize=23)
    ax.tick_params(axis="y", colors="grey", labelsize=23)
    ax.plot(_host(array))
    if path is not None:
        fig.savefig(f"{path}.png", bbox_inches="tight")
        plt.close(fig)
        return
    plt.show()


def plot_spec(M, path=None):
    """Interactive spectrogram plot (reference utils/display.py:114-120);
    pass ``path`` to save a png instead (headless)."""
    plt = _plt()
    fig = plt.figure(figsize=(18, 4))
    plt.imshow(np.flip(_host(M), axis=0), interpolation="nearest",
               aspect="auto")
    if path is not None:
        fig.savefig(f"{path}.png", bbox_inches="tight")
        plt.close(fig)
        return
    plt.show()
