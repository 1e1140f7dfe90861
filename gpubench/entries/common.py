"""What the entries share: the port's Config from a configuration file,
and the build of the program's kernel libraries."""
from __future__ import annotations

import time


def port_config(cfg: dict, mode: str = "teacher_forcing"):
    """The program's ``Config`` holding the configuration file's sizes."""
    from wavernn_tpu_torch.config import (Config, DSPConfig, TacotronConfig,
                                          WaveRNNConfig)
    dsp = DSPConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"],
                    num_mels=cfg["num_mels"], hop_length=cfg["hop_length"],
                    win_length=cfg["win_length"], fmin=cfg["fmin"],
                    bits=cfg["bits"], mu_law=cfg["mu_law"])
    voc = WaveRNNConfig(mode=cfg["voc_mode"],
                        upsample_factors=tuple(cfg["voc_upsample_factors"]),
                        rnn_dims=cfg["voc_rnn_dims"],
                        fc_dims=cfg["voc_fc_dims"],
                        compute_dims=cfg["voc_compute_dims"],
                        res_out_dims=cfg["voc_res_out_dims"],
                        res_blocks=cfg["voc_res_blocks"], pad=cfg["voc_pad"],
                        target=cfg["voc_target"], overlap=cfg["voc_overlap"])
    tts = TacotronConfig(embed_dims=cfg["tts_embed_dims"],
                         encoder_dims=cfg["tts_encoder_dims"],
                         decoder_dims=cfg["tts_decoder_dims"],
                         postnet_dims=cfg["tts_postnet_dims"],
                         encoder_K=cfg["tts_encoder_K"],
                         lstm_dims=cfg["tts_lstm_dims"],
                         postnet_K=cfg["tts_postnet_K"],
                         num_highways=cfg["tts_num_highways"],
                         dropout=cfg["tts_dropout"],
                         stop_threshold=cfg["tts_stop_threshold"],
                         max_r=cfg["tts_max_r"],
                         cleaner_names=tuple(cfg["tts_cleaner_names"]),
                         mode=mode)
    return Config(dsp=dsp, voc=voc, tts=tts)


def build(split: dict) -> None:
    """Compile the program's kernel sources in parallel, each only once per
    checkout (the port keeps them in wavernn_tpu_torch/_build/ by the hash
    of the source: a warm checkout builds nothing). The libraries load at
    their first use, in the warm-up."""
    from wavernn_tpu_torch.ops import _build
    t = time.time()
    _build.build_all()
    split["build_s"] = time.time() - t
