"""Workspace path registry (port of ``wavernn_tpu.paths``, the reference's
``utils/paths.py`` layout): the data, vocoder and Tacotron paths, with the
Tacotron trainer's attention and mel plot folders. Datasets and checkpoints
are interchangeable with the JAX package's runs."""
from __future__ import annotations

from pathlib import Path


class Workspace:
    def __init__(self, data_path, voc_id: str, tts_id: str,
                 ignore_voc: bool = False, ignore_tts: bool = False,
                 output_root: str = "."):
        self.base = Path(output_root).expanduser().resolve()
        self.data = Path(data_path).expanduser()

        # data artifacts (the reference pipeline's layout)
        self.quant = self.data / "quant"
        self.mel = self.data / "mel"
        self.gta = self.data / ("gta" if ignore_tts else f"gta_{tts_id}")
        self.attn = self.data / f"attn_{tts_id}"

        # vocoder
        self.voc_checkpoints = self.base / "checkpoints" / f"{voc_id}.wavernn"
        self.voc_latest_weights = self.voc_checkpoints / "latest_weights.npz"
        self.voc_latest_optim = self.voc_checkpoints / "latest_optim.npz"
        self.voc_output = self.base / "model_outputs" / f"{voc_id}.wavernn"
        self.voc_log = self.voc_checkpoints / "log.txt"
        self.voc_metrics = self.voc_checkpoints / "metrics.jsonl"

        # tacotron
        self.tts_checkpoints = self.base / "checkpoints" / f"{tts_id}.tacotron"
        self.tts_latest_weights = self.tts_checkpoints / "latest_weights.npz"
        self.tts_latest_optim = self.tts_checkpoints / "latest_optim.npz"
        self.tts_output = self.base / "model_outputs" / f"{tts_id}.tacotron"
        self.tts_log = self.tts_checkpoints / "log.txt"
        self.tts_metrics = self.tts_checkpoints / "metrics.jsonl"
        self.tts_attention = self.tts_checkpoints / "attention"
        self.tts_mel_plot = self.tts_checkpoints / "mel_plots"

        self.create(ignore_voc=ignore_voc, ignore_tts=ignore_tts)

    def create(self, ignore_voc: bool = False, ignore_tts: bool = False):
        for p in (self.data, self.quant, self.mel, self.gta):
            p.mkdir(parents=True, exist_ok=True)
        if not ignore_voc:
            for p in (self.voc_checkpoints, self.voc_output):
                p.mkdir(parents=True, exist_ok=True)
        if not ignore_tts:
            for p in (self.tts_checkpoints, self.tts_output,
                      self.tts_attention, self.tts_mel_plot):
                p.mkdir(parents=True, exist_ok=True)

    def get_voc_named_weights(self, name: str) -> Path:
        return self.voc_checkpoints / f"{name}_weights.npz"

    def get_voc_named_optim(self, name: str) -> Path:
        return self.voc_checkpoints / f"{name}_optim.npz"

    def get_tts_named_weights(self, name: str) -> Path:
        return self.tts_checkpoints / f"{name}_weights.npz"

    def get_tts_named_optim(self, name: str) -> Path:
        return self.tts_checkpoints / f"{name}_optim.npz"
