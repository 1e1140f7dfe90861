"""Typed, frozen configuration for the PyTorch/CUDA port.

A copy of the inference-side dataclasses of ``wavernn_tpu.config``
(DSPConfig, WaveRNNConfig, TacotronConfig, Config) and of the reference
``hparams_*.py`` loader, cut to the fields that text -> wav synthesis
reads. The training settings stay with the JAX package until training is
ported.
"""
from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple, Union


def _import_py_file(path: Union[str, Path]):
    path = Path(path).expanduser()
    if not path.exists():
        raise FileNotFoundError(f"Could not find hparams file {path}")
    if path.suffix != ".py":
        raise ValueError("`path` must be a python file")
    spec = importlib.util.spec_from_file_location("hparams_ext", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class DSPConfig:
    """Audio analysis settings (reference hparams.py:20-32)."""

    sample_rate: int = 22050
    n_fft: int = 2048
    num_mels: int = 80
    hop_length: int = 275       # 12.5 ms
    win_length: int = 1100      # 50 ms
    fmin: float = 40.0
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    bits: int = 9
    mu_law: bool = True
    peak_norm: bool = False


@dataclass(frozen=True)
class WaveRNNConfig:
    """Vocoder model + generation settings (reference hparams.py:34-60)."""

    mode: str = "MOL"  # 'RAW' (softmax over 2**bits) or 'MOL'
    upsample_factors: Tuple[int, ...] = (5, 5, 11)
    rnn_dims: int = 512
    fc_dims: int = 512
    compute_dims: int = 128
    res_out_dims: int = 128
    res_blocks: int = 10
    pad: int = 2
    target: int = 11_000
    overlap: int = 550

    @property
    def aux_dims(self) -> int:
        return self.res_out_dims // 4

    def n_classes(self, bits: int) -> int:
        if self.mode == "RAW":
            return 2 ** bits
        if self.mode == "MOL":
            return 30
        raise ValueError(f"Unknown WaveRNN mode {self.mode!r}")


@dataclass(frozen=True)
class TacotronConfig:
    """TTS model settings (reference hparams.py:66-80)."""

    embed_dims: int = 256
    encoder_dims: int = 128
    decoder_dims: int = 256
    postnet_dims: int = 128
    encoder_K: int = 16
    lstm_dims: int = 512
    postnet_K: int = 8
    num_highways: int = 4
    dropout: float = 0.5
    stop_threshold: float = -3.4
    max_r: int = 20
    cleaner_names: Tuple[str, ...] = ("english_cleaners",)


@dataclass(frozen=True)
class Config:
    """The settings text -> wav synthesis reads."""

    dsp: DSPConfig = field(default_factory=DSPConfig)
    voc: WaveRNNConfig = field(default_factory=WaveRNNConfig)
    tts: TacotronConfig = field(default_factory=TacotronConfig)

    def __post_init__(self):
        total = math.prod(self.voc.upsample_factors)
        if total != self.dsp.hop_length:
            raise ValueError(
                f"upsample_factors {self.voc.upsample_factors} must factorise "
                f"hop_length {self.dsp.hop_length} (product={total})")

    @classmethod
    def from_hparams_file(cls, path: Union[str, Path]) -> "Config":
        """Load the synthesis fields of a reference-style hparams file."""
        m = _import_py_file(path)
        g = lambda name, default=None: getattr(m, name, default)
        dsp = DSPConfig(
            sample_rate=g("sample_rate", 22050),
            n_fft=g("n_fft", 2048),
            num_mels=g("num_mels", 80),
            hop_length=g("hop_length", 275),
            win_length=g("win_length", 1100),
            fmin=g("fmin", 40.0),
            min_level_db=g("min_level_db", -100.0),
            ref_level_db=g("ref_level_db", 20.0),
            bits=g("bits", 9),
            mu_law=g("mu_law", True),
            peak_norm=g("peak_norm", False),
        )
        voc = WaveRNNConfig(
            mode=g("voc_mode", "MOL"),
            upsample_factors=tuple(g("voc_upsample_factors", (5, 5, 11))),
            rnn_dims=g("voc_rnn_dims", 512),
            fc_dims=g("voc_fc_dims", 512),
            compute_dims=g("voc_compute_dims", 128),
            res_out_dims=g("voc_res_out_dims", 128),
            res_blocks=g("voc_res_blocks", 10),
            pad=g("voc_pad", 2),
            target=g("voc_target", 11_000),
            overlap=g("voc_overlap", 550),
        )
        tts = TacotronConfig(
            embed_dims=g("tts_embed_dims", 256),
            encoder_dims=g("tts_encoder_dims", 128),
            decoder_dims=g("tts_decoder_dims", 256),
            postnet_dims=g("tts_postnet_dims", 128),
            encoder_K=g("tts_encoder_K", 16),
            lstm_dims=g("tts_lstm_dims", 512),
            postnet_K=g("tts_postnet_K", 8),
            num_highways=g("tts_num_highways", 4),
            dropout=g("tts_dropout", 0.5),
            stop_threshold=g("tts_stop_threshold", -3.4),
            cleaner_names=tuple(g("tts_cleaner_names", ("english_cleaners",))),
        )
        return cls(dsp=dsp, voc=voc, tts=tts)
