"""Typed, frozen configuration for the PyTorch/CUDA port.

A copy of the dataclasses of ``wavernn_tpu.config`` (DSPConfig,
WaveRNNConfig, WaveRNNTrainConfig, TacotronConfig, Config) and of the
reference ``hparams_*.py`` loader, cut to the fields that preprocessing,
text -> wav synthesis, vocoder training and Tacotron training read.
"""
from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union


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
    gen_batched: bool = True
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


_PRECISIONS = ("float32", "bfloat16")


@dataclass(frozen=True)
class WaveRNNTrainConfig:
    """Vocoder training loop settings (reference hparams.py:46-55)."""

    batch_size: int = 32
    lr: float = 1e-4
    checkpoint_every: int = 25_000
    gen_at_checkpoint: int = 5
    total_steps: int = 1_000_000
    test_samples: int = 50
    seq_len: int = 275 * 5  # must be a multiple of hop_length
    clip_grad_norm: Optional[float] = 4.0
    init_weights_path: Optional[str] = None
    # "bfloat16": the core GRU/FC stack computes in bf16 (float32 master
    # weights, optimizer state, upsampler and BatchNorm statistics)
    precision: str = "float32"
    # the two GRU recurrences: "auto" and "pallas" run the kernel B5 on a
    # CUDA tensor (its plain version on a CPU tensor); "scan" runs the
    # plain step loop under autograd, explicitly asked for
    recurrence: str = "auto"
    # magnitude pruning (reference notebooks/Pruning - Scratchpad.ipynb
    # cells 4-6: cubic schedule, demo target 0.9375; train/pruning.py).
    # prune_block (rows, cols) in the JAX package's (in, out) layout makes
    # the zero pattern whole (128, 128) blocks that the sample loops' sparse
    # arm skips; None = the notebook's unstructured masks
    prune: bool = False
    prune_start: int = 20_000
    prune_steps: int = 200_000
    prune_sparsity: float = 0.9375
    prune_every: int = 500
    prune_block: Optional[Tuple[int, int]] = (128, 128)
    prune_rnn_input: bool = True

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, got "
                f"{self.precision!r}")
        if self.recurrence not in ("auto", "scan", "pallas"):
            raise ValueError(
                f"recurrence must be auto/scan/pallas, got {self.recurrence!r}")
        if not 0.0 <= self.prune_sparsity < 1.0:
            raise ValueError(
                f"prune_sparsity must be in [0, 1), got {self.prune_sparsity}")


TTS_MODES = ("teacher_forcing", "attention_forcing_online",
             "attention_forcing_offline", "free_running")


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
    # run mode (one of TTS_MODES): teacher_forcing | attention_forcing_online
    # (a frozen TF teacher's attention, KL loss) | attention_forcing_offline
    # (attention maps from disk, L1 loss) | free_running; the trainer runs
    # the two attention-forcing modes as such and any other as teacher
    # forcing, as the JAX package's does
    mode: str = "teacher_forcing"

    def __post_init__(self):
        if self.mode not in TTS_MODES:
            raise ValueError(f"mode must be one of {TTS_MODES}, got "
                             f"{self.mode!r}")


@dataclass(frozen=True)
class TacotronTrainConfig:
    """TTS training schedule (reference hparams.py:82-93 and the fork's
    extras)."""

    # (r, lr, step, batch_size) progressive schedule
    schedule: Tuple[Tuple[int, float, int, int], ...] = (
        (7, 1e-3, 10_000, 32),
        (5, 1e-4, 100_000, 32),
        (2, 1e-4, 180_000, 16),
        (2, 1e-4, 350_000, 8),
    )
    max_mel_len: Optional[int] = 1250
    bin_lengths: bool = True
    clip_grad_norm: Optional[float] = 1.0
    checkpoint_every: int = 2_000
    # "bfloat16": mixed precision (float32 master weights, optimizer state,
    # BatchNorm statistics, losses and attention normalisation; bfloat16
    # activations, streams and matmul operands on B5, B6 and B7)
    precision: str = "float32"
    # the decoder recurrence (kernel B6) and the CBHG BiGRUs (kernel B5):
    # "auto" and "pallas" run the kernels on CUDA tensors (their plain
    # versions on CPU tensors); "scan" runs the plain step loops under
    # autograd, explicitly asked for
    recurrence: str = "auto"
    init_weights_path: Optional[str] = None
    attn_loss_coeff: float = 1.0
    attn_ref_path: Optional[str] = None
    model_tf_path: Optional[str] = None

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, got "
                f"{self.precision!r}")
        if self.recurrence not in ("auto", "scan", "pallas"):
            raise ValueError(
                f"recurrence must be auto/scan/pallas, got {self.recurrence!r}")


@dataclass(frozen=True)
class Config:
    """The settings preprocessing, text -> wav synthesis, vocoder training
    and Tacotron training read."""

    wav_path: str = "data/wavs"
    data_path: str = "data/"
    voc_model_id: str = "ljspeech_mol"
    tts_model_id: str = "ljspeech_lsa_smooth_attention"
    ignore_tts: bool = False
    ignore_voc: bool = False
    dsp: DSPConfig = field(default_factory=DSPConfig)
    voc: WaveRNNConfig = field(default_factory=WaveRNNConfig)
    voc_train: WaveRNNTrainConfig = field(default_factory=WaveRNNTrainConfig)
    tts: TacotronConfig = field(default_factory=TacotronConfig)
    tts_train: TacotronTrainConfig = field(
        default_factory=TacotronTrainConfig)
    # the hparams' random_seed: the Tacotron trainer's seed when set
    random_seed: Optional[int] = None
    test_sentences_file: Optional[str] = None
    test_sentences_names: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        total = math.prod(self.voc.upsample_factors)
        if total != self.dsp.hop_length:
            raise ValueError(
                f"upsample_factors {self.voc.upsample_factors} must factorise "
                f"hop_length {self.dsp.hop_length} (product={total})")
        if self.voc_train.seq_len % self.dsp.hop_length != 0:
            raise ValueError("voc seq_len must be a multiple of hop_length")

    @classmethod
    def from_hparams_file(cls, path: Union[str, Path]) -> "Config":
        """Load the synthesis and training fields of a reference-style
        hparams file."""
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
            gen_batched=g("voc_gen_batched", True),
            target=g("voc_target", 11_000),
            overlap=g("voc_overlap", 550),
        )
        voc_train = WaveRNNTrainConfig(
            batch_size=g("voc_batch_size", 32),
            lr=g("voc_lr", 1e-4),
            checkpoint_every=g("voc_checkpoint_every", 25_000),
            gen_at_checkpoint=g("voc_gen_at_checkpoint", 5),
            total_steps=g("voc_total_steps", 1_000_000),
            test_samples=g("voc_test_samples", 50),
            seq_len=g("voc_seq_len", g("hop_length", 275) * 5),
            clip_grad_norm=g("voc_clip_grad_norm", 4.0),
            init_weights_path=g("voc_init_weights_path"),
            precision=g("voc_precision", "float32"),
            recurrence=g("voc_recurrence", "auto"),
            prune=g("voc_prune", False),
            prune_start=g("voc_prune_start", 20_000),
            prune_steps=g("voc_prune_steps", 200_000),
            prune_sparsity=g("voc_prune_sparsity", 0.9375),
            prune_every=g("voc_prune_every", 500),
            prune_block=(tuple(g("voc_prune_block"))
                         if g("voc_prune_block") is not None else
                         (None if g("voc_prune_unstructured", False)
                          else (128, 128))),
            prune_rnn_input=g("voc_prune_rnn_input", True),
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
            mode=g("mode", "teacher_forcing"),
        )
        tts_train = TacotronTrainConfig(
            schedule=tuple(tuple(s) for s in g(
                "tts_schedule", TacotronTrainConfig().schedule)),
            max_mel_len=g("tts_max_mel_len", 1250),
            bin_lengths=g("tts_bin_lengths", True),
            clip_grad_norm=g("tts_clip_grad_norm", 1.0),
            checkpoint_every=g("tts_checkpoint_every", 2_000),
            precision=g("tts_precision", "float32"),
            recurrence=g("tts_recurrence", "auto"),
            init_weights_path=g("tts_init_weights_path"),
            attn_loss_coeff=g("attn_loss_coeff", 1.0),
            attn_ref_path=g("attn_ref_path"),
            model_tf_path=g("model_tf_path"),
        )
        names = g("test_sentences_names")
        return cls(
            wav_path=g("wav_path", "data/wavs"),
            data_path=g("data_path", "data/"),
            voc_model_id=g("voc_model_id", "ljspeech_mol"),
            tts_model_id=g("tts_model_id", "ljspeech_lsa_smooth_attention"),
            ignore_tts=g("ignore_tts", False),
            ignore_voc=g("ignore_voc", False),
            dsp=dsp, voc=voc, voc_train=voc_train, tts=tts,
            tts_train=tts_train,
            random_seed=g("random_seed"),
            test_sentences_file=g("test_sentences_file"),
            test_sentences_names=tuple(names) if names else None)
