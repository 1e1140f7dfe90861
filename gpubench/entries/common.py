"""What the entries share: the port's Config from a configuration file,
the build of the program's kernel libraries, the training cells' first
steps and their check, and TF32 for the controls."""
from __future__ import annotations

import statistics
import sys
import time
from contextlib import contextmanager

import torch


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


def first_steps(step, batches, model, opt, P0) -> tuple:
    """Set-up's first steps, ``step(b, None)`` on each batch in turn, and
    what the check reads of them: (each step's loss, each leaf's norm of
    the first step's clipped gradient as the optimizer holds it, each
    leaf's norm of the change over all the steps)."""
    names = [k for k, _ in model.named_parameters()]
    losses, first = [], None
    for b in batches:
        losses.append(step(b, None)["loss"])
        if first is None:
            st = opt.adam.state
            # Adam's first moment after one step is (1 - b1) g
            first = {n: float(torch.linalg.vector_norm(st[p]["exp_avg"])
                              / (1 - 0.9)) if p in st else 0.0
                     for n, p in zip(names, model.parameters())}
    change = {n: float(torch.linalg.vector_norm(p.detach() - P0[n]))
              for n, p in model.named_parameters()}
    return [float(x) for x in losses], first, change


def judge_steps(losses, first, change, ref):
    """The program's steps, one a batch, against the reference's ``ref``
    (its losses, first gradients and changes): the widest relative gap of
    a step's loss; of a leaf's norm of the first clipped gradient; of a
    leaf's norm of the change over all the steps. A leaf's gap is measured
    against its reference norm or the median leaf's, whichever is larger;
    leaves whose reference gradient is under a thousandth of the median
    leaf's (moved by round-off alone under Adam) are left out of the
    change."""
    r_losses, r_first, r_change = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    med_g = statistics.median(r_first.values())
    grad = {k: abs(first[k] - g) / max(g, med_g) for k, g in r_first.items()}
    kept = [k for k, g in r_first.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(r_change[k] for k in kept)
    change = {k: abs(change[k] - r_change[k]) / max(r_change[k], med_c)
              for k in kept}
    wg, wc = max(grad, key=grad.get), max(change, key=change.get)
    print(f"judge: worst gradient leaf {wg} ({r_first[wg]:.4g} of median "
          f"{med_g:.4g}), worst change leaf {wc} ({r_change[wc]:.4g} of "
          f"median {med_c:.4g}); {len(r_first) - len(kept)} leaves left out",
          file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": grad[wg],
            "change_gap": change[wc]}


@contextmanager
def tf32():
    """Every float32 product and convolution of torch in TF32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
