"""CLI: vocoder copy-synthesis with the PyTorch/CUDA port (reference
gen_wavernn.py; the flag surface of ``wavernn_tpu.cli.gen_wavernn``).

    python -m wavernn_tpu_torch.cli.gen_wavernn [--file x.wav] [-w w.npz]
    python -m wavernn_tpu_torch.cli.gen_wavernn --sparse -u   # pruned model

Generates the held-out items of the dataset (or one ``.wav``, analysed
again, or one saved [0, 1] mel ``.npy``) from the latest vocoder
checkpoint, fold-batched or unbatched.
The device picks the engine: on CUDA the sample-loop kernels run (with
``--sparse``, their block-sparse arm), with ``--force_cpu`` their plain
PyTorch versions. Wavs go to ``model_outputs/<voc_id>.wavernn/`` under the
JAX package's names.
"""
from __future__ import annotations

import argparse

import torch

from ..data.dataset import get_vocoder_datasets
from ..device import resolve_device
from ..synthesis import gen_from_file, gen_testset
from .common import load_config, load_voc_model, make_workspace, \
    sparse_pack_or_dense


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate WaveRNN samples (PyTorch). The device picks the "
                    "engine: the kernels on CUDA, their plain versions with "
                    "--force_cpu.")
    parser.add_argument("--batched", "-b", dest="batched", action="store_true")
    parser.add_argument("--unbatched", "-u", dest="batched",
                        action="store_false")
    parser.set_defaults(batched=None)
    parser.add_argument("--samples", "-s", type=int)
    parser.add_argument("--target", "-t", type=int)
    parser.add_argument("--overlap", "-o", type=int)
    parser.add_argument("--file", "-f",
                        help="a .wav (its mel is computed again) or a saved "
                             "[0, 1] mel .npy to vocode")
    parser.add_argument("--weights", "--voc_weights", "-w", dest="weights",
                        help="weights file (.npz or .pyt)")
    parser.add_argument("--gta", "-g", action="store_true")
    parser.add_argument("--pallas", dest="pallas", action="store_true",
                        default=None,
                        help="accepted for the JAX package's flag surface; "
                             "means nothing here (the device picks the "
                             "engine)")
    parser.add_argument("--no_pallas", dest="pallas", action="store_false",
                        help="accepted and ignored, as --pallas")
    parser.add_argument("--sparse", action="store_true",
                        help="serve a block-pruned checkpoint through the "
                             "sample loops' block-sparse arm (weights are "
                             "packed once at load; matrices that are not "
                             "block-sparse stay dense)")
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.force_cpu else "cuda")

    cfg = load_config(args.hp_file)
    ws = make_workspace(cfg)
    batched = cfg.voc.gen_batched if args.batched is None else args.batched
    samples = args.samples or cfg.voc_train.gen_at_checkpoint
    target = args.target or cfg.voc.target
    overlap = args.overlap or cfg.voc.overlap

    voc, step = load_voc_model(args.weights or ws.voc_latest_weights, cfg,
                               device)
    sparse_packed = sparse_pack_or_dense(voc, cfg) if args.sparse else None
    for name, value in (
            ("Generation Mode", "Batched" if batched else "Unbatched"),
            ("Target Samples", target if batched else "N/A"),
            ("Overlap Samples", overlap if batched else "N/A"),
            ("Step", f"{step // 1000}k"), ("Device", device)):
        print(f"| {name}: {value}")

    gen = torch.Generator().manual_seed(0)
    if args.file:
        gen_from_file(voc, args.file, ws.voc_output, batched, target, overlap,
                      cfg, step=step, generator=gen, device=device,
                      sparse_packed=sparse_packed)
    else:
        _, test_set = get_vocoder_datasets(ws.data, 1, cfg,
                                           train_gta=args.gta)
        gen_testset(voc, test_set, samples, batched, target, overlap,
                    ws.voc_output, cfg, step=step, generator=gen,
                    device=device, sparse_packed=sparse_packed)
    print("\nExiting...")


if __name__ == "__main__":
    main()
