"""DSP stack of the port (wavernn_tpu.dsp's exports; ``stft`` and
``melspectrogram`` take the place of ``stft_jax`` and ``melspectrogram_jax``,
``istft``, ``mel_to_stft`` and ``griffinlim`` of their ``*_jax``)."""
from .audio import (
    combine_signal,
    de_emphasis,
    decode_mu_law,
    encode_16bits,
    encode_mu_law,
    float_2_label,
    label_2_float,
    load_wav,
    pre_emphasis,
    save_wav,
    split_signal,
)
from .mel import (
    amp_to_db,
    db_to_amp,
    denormalize,
    hann_window,
    istft_np,
    mel_filterbank,
    melspectrogram,
    melspectrogram_np,
    normalize,
    spectrogram_np,
    stft,
    stft_np,
)
from .griffinlim import griffinlim, istft, mel_to_stft, reconstruct_waveform

__all__ = [
    "combine_signal", "de_emphasis", "decode_mu_law", "encode_16bits",
    "encode_mu_law", "float_2_label", "label_2_float", "load_wav",
    "pre_emphasis", "save_wav", "split_signal",
    "amp_to_db", "db_to_amp", "denormalize", "hann_window", "istft_np",
    "mel_filterbank", "melspectrogram", "melspectrogram_np", "normalize",
    "spectrogram_np", "stft", "stft_np",
    "griffinlim", "istft", "mel_to_stft", "reconstruct_waveform",
]
