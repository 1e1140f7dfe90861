"""A cell of the benchmark cut to a size the CPU runs in seconds: the
same files, with narrower layers, shorter folds and a shorter mix. The
program then runs its plain versions, which its own tests hold to the
kernels; what this exercises is the harness around them."""
from __future__ import annotations

import copy
import json
import time

from gpubench import harness

TINY_CFG = {"voc_rnn_dims": 32, "voc_fc_dims": 32, "voc_compute_dims": 16,
            "voc_res_out_dims": 16, "voc_res_blocks": 2, "voc_target": 550,
            "voc_overlap": 275, "tts_embed_dims": 32, "tts_lstm_dims": 32,
            "tts_postnet_dims": 16, "tts_encoder_K": 3, "tts_postnet_K": 3,
            "tts_num_highways": 1}
# the CPU runs the program's plain versions, whose sample loop multiplies
# float32 weights where the reference rounds them to bfloat16 as the card's
# kernel does (about 6e-4 apart at these widths): the cut cells' limits
TINY_LIMITS = {"mel_gap": 1e-4, "sample_gap": 2e-3, "loss_gap": 1e-4,
               "grad_gap": 1e-3, "change_gap": 2e-2}
TINY_MIX = {"tts_batch": {"batch": 2, "lengths": [6, 9, 12, 15],
                          "judge_calls": 2, "judge_margin": 32},
            "tts_single": {"lengths": [6, 9, 12, 15], "judge_calls": 2,
                           "judge_margin": 32},
            "train_af": {"max_frames": [20, 30, 40, 50],
                         "spread": [1.0, 0.8]}}


def spec(cell: str, root=harness.ROOT) -> dict:
    """The cell's spec with the cut widths, mix and limits. The entry the
    mix names may bring its own cut: ``TINY_MIX`` (merged over the mix),
    ``TINY_CFG`` (merged over the shared widths) and ``TINY_LIMITS`` (for
    its own check numbers). Otherwise the tables here apply; a mix they do
    not know is cut as the first of its entry's."""
    s = copy.deepcopy(harness.cell_spec(harness.load_manifest(root), cell,
                                        root))
    entry = harness.entry_module(root, s["mix"]["entry"])
    s["cfg"].update(TINY_CFG)
    s["cfg"].update(getattr(entry, "TINY_CFG", {}))
    cut = getattr(entry, "TINY_MIX", None)
    if cut is None:
        cut = TINY_MIX.get(s["cell"]["traffic"])
    if cut is None:
        cut = {k: v for k, v in next(
            m for t, m in TINY_MIX.items()
            if json.loads((harness.HERE / "workloads"
                           / f"{t}.json").read_text())["entry"]
            == s["mix"]["entry"]).items() if k != "batch"}
    s["mix"].update(cut)
    limits = {**TINY_LIMITS, **getattr(entry, "TINY_LIMITS", {})}
    s["limits"] = {k: limits[k] for k in s["limits"]}
    return s


def run(cell: str, seed: int = 7, seconds: float = 0.5, trace=False,
        entry_patch=None, root=harness.ROOT):
    """One run of the cut cell on the CPU: (result line, check lines)."""
    import torch
    return harness.run_cell(spec(cell, root), seed, seconds, trace,
                            torch.device("cpu"), time.time(),
                            entry_patch=entry_patch)
