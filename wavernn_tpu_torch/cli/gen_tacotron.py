"""CLI: end-to-end TTS synthesis with the PyTorch/CUDA port (reference
gen_tacotron.py; the flag surface of ``wavernn_tpu.cli.gen_tacotron``).

    python -m wavernn_tpu_torch.cli.gen_tacotron wavernn --input_text "Hello."
    python -m wavernn_tpu_torch.cli.gen_tacotron wavernn --batch_sentences
    python -m wavernn_tpu_torch.cli.gen_tacotron --force_cpu wavernn --fast
    python -m wavernn_tpu_torch.cli.gen_tacotron -a griffinlim --iters 32

The device picks the engine: on CUDA the decode, sample-loop and GRU
kernels run; ``--force_cpu`` runs their plain PyTorch versions on the CPU.
``wavernn --sparse`` serves a block-pruned vocoder (``train_wavernn
--prune``) through the sample loops' block-sparse arm. ``griffinlim`` loads
no vocoder: NNLS and Griffin-Lim invert the postnet mel on the device.
``--save_attention`` writes each sentence's attention beside its wav
(``<wav name>.png``) on the per-sentence paths.
Checkpoints are the JAX trainer's ``.npz`` (either package writes them) or
reference ``.pyt`` state dicts. Wavs go to ``model_outputs/<tts_id>.tacotron/``
under the names the JAX package gives them.
"""
from __future__ import annotations

import argparse

import torch

from ..dsp.audio import save_wav
from ..synthesis import tts_to_wav, tts_to_wav_batch, tts_to_wav_fast
from ..utils.display import save_attention, simple_table
from .common import load_config, load_tts_model, load_voc_model, \
    make_workspace, sparse_pack_or_dense


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="TTS Generator (PyTorch). The device picks the engine: "
                    "the kernels on CUDA, their plain versions with "
                    "--force_cpu.")
    parser.add_argument("--input_text", "-i", default=None)
    parser.add_argument("--save_attention", "-a", action="store_true")
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    parser.add_argument("--use_standard_names", action="store_true")
    subs = parser.add_subparsers(dest="vocoder", required=True)

    wr_p = subs.add_parser("wavernn")
    wr_p.add_argument("--batched", "-b", dest="batched", action="store_true")
    wr_p.add_argument("--unbatched", "-u", dest="batched",
                      action="store_false")
    wr_p.set_defaults(batched=None)
    wr_p.add_argument("--target", "-t", type=int, default=None,
                      help="samples per fold (overrides hparams)")
    wr_p.add_argument("--overlap", "-o", type=int, default=None,
                      help="crossover samples (overrides hparams)")
    wr_p.add_argument("--voc_weights", default=None)
    wr_p.add_argument("--tts_weights", default=None)
    wr_p.add_argument("--pallas", dest="pallas", action="store_true",
                      default=None,
                      help="accepted for the JAX package's flag surface; "
                           "means nothing here (the device picks the "
                           "engine)")
    wr_p.add_argument("--no_pallas", dest="pallas", action="store_false",
                      help="accepted and ignored, as --pallas")
    wr_p.add_argument("--sparse", action="store_true",
                      help="serve a block-pruned vocoder checkpoint through "
                           "the sample loops' block-sparse arm (weights "
                           "packed once at load; matrices that are not "
                           "block-sparse stay dense)")
    wr_p.add_argument("--fast", action="store_true",
                      help="device-resident serving path (one scalar sync, "
                           "length-bucketed vocoder) instead of the "
                           "reference host-roundtrip flow")
    wr_p.add_argument("--batch_sentences", action="store_true",
                      help="synthesize ALL input sentences together: one "
                           "pad-masked batched Tacotron decode + one "
                           "batched vocoder launch (tts_to_wav_batch) "
                           "instead of the reference's per-sentence loop")

    gl_p = subs.add_parser("griffinlim")
    gl_p.add_argument("--iters", type=int, default=32)
    gl_p.add_argument("--tts_weights", default=None)

    args = parser.parse_args(argv)
    device = "cpu" if args.force_cpu else "cuda"
    cfg = load_config(args.hp_file)
    ws = make_workspace(cfg)
    ws.tts_output.mkdir(parents=True, exist_ok=True)

    tts, tts_step, r = load_tts_model(args.tts_weights
                                      or ws.tts_latest_weights, cfg, device)
    tts_k = tts_step // 1000
    gl = args.vocoder == "griffinlim"
    voc = sparse_packed = target = overlap = None
    batched = True
    if gl:
        simple_table([("Tacotron", f"{tts_k}k"), ("r", r),
                      ("Vocoder Type", "Griffin-Lim"),
                      ("GL Iters", args.iters)])
    else:
        voc, voc_step = load_voc_model(
            args.voc_weights or ws.voc_latest_weights, cfg, device)
        sparse_packed = (sparse_pack_or_dense(voc, cfg) if args.sparse
                         else None)
        batched = cfg.voc.gen_batched if args.batched is None \
            else args.batched
        target = cfg.voc.target if args.target is None else args.target
        overlap = cfg.voc.overlap if args.overlap is None else args.overlap
        print(f"| Tacotron {tts_k}k, r={r}, WaveRNN {voc_step // 1000}k, "
              + (f"batched (target {target}, overlap {overlap})" if batched
                 else "unbatched") + f", on {device}")
    fast = getattr(args, "fast", False)
    batch_sentences = getattr(args, "batch_sentences", False)
    if fast and args.save_attention:
        print("| WARNING: --save_attention is not available with --fast "
              "(the device-resident path never materializes attention maps); "
              "rerun without --fast to dump attention plots")
    if fast and args.batched is False:
        print("| WARNING: --fast is always fold-batched; ignoring --unbatched")

    if args.input_text:
        inputs = [args.input_text.strip()]
    else:
        sent_file = cfg.test_sentences_file or "test_sentences/sentences.txt"
        with open(sent_file) as f:
            inputs = [line.strip() for line in f if line.strip()]

    def save_path(i, v_type):
        if args.use_standard_names and cfg.test_sentences_names:
            return ws.tts_output / f"{cfg.test_sentences_names[i - 1]}.wav"
        if args.input_text:
            return (ws.tts_output
                    / f"__input_{args.input_text[:10]}_{v_type}_{tts_k}k.wav")
        return ws.tts_output / f"{i}_{v_type}_{tts_k}k.wav"

    if batch_sentences:
        if args.save_attention:
            print("| WARNING: --save_attention is not available with "
                  "--batch_sentences (the batched path never materializes "
                  "attention maps); rerun without it for attention plots")
        if fast:
            print("| WARNING: --batch_sentences supersedes --fast (the "
                  "batched path is already device-resident)")
        print(f"| Generating {len(inputs)} sentences in one batch")
        outs = tts_to_wav_batch(tts, voc, inputs, cfg, r,
                                generator=torch.Generator().manual_seed(1),
                                target=target, overlap=overlap, device=device,
                                sparse_packed=sparse_packed)
        for i, (wav, _) in enumerate(outs, 1):
            save_wav(wav, save_path(i, "wavernn_batchN"), cfg.dsp.sample_rate)
        print("Done.")
        return

    for i, text in enumerate(inputs, 1):
        print(f"| Generating {i}/{len(inputs)}")
        gen = torch.Generator().manual_seed(i)
        attention = None
        if fast:
            wav, _ = tts_to_wav_fast(tts, voc, text, cfg, r, generator=gen,
                                     target=target, overlap=overlap,
                                     device=device,
                                     sparse_packed=sparse_packed)
            v_type = "wavernn_fast"
        else:
            wav, _, attention = tts_to_wav(
                tts, voc, text, cfg, r, generator=gen, target=target,
                overlap=overlap, device=device, batched=batched,
                sparse_packed=sparse_packed, vocoder=args.vocoder,
                gl_iters=getattr(args, "iters", 32))
            v_type = ("griffinlim" if gl else "wavernn_batched" if batched
                      else "wavernn_unbatched")
        path = save_path(i, v_type)
        if args.save_attention and attention is not None:
            save_attention(attention, path)
        save_wav(wav, path, cfg.dsp.sample_rate)
    print("Done.")


if __name__ == "__main__":
    main()
