"""Synthesis flows (port of ``wavernn_tpu.synthesis``): copy-synthesis of
held-out items, of a saved mel or of a ``.wav``, and text -> wav with the
WaveRNN or the Griffin-Lim vocoder (reference gen_wavernn.py:11-65,
gen_tacotron.py:142-173), and the serving paths:
``tts_to_wav_fast`` (one sentence, device-resident, length-bucketed) and
``tts_to_wav_batch`` (many sentences: one batched decode, one vocoder
launch). Every flow takes ``sparse_packed``: the ``ops/cuda_gen.pack_sparse``
of a block-pruned vocoder, served through the sample loops' sparse arm (B9).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .dsp.audio import decode_mu_law, label_2_float, load_wav, save_wav
from .dsp.griffinlim import reconstruct_waveform
from .dsp.mel import melspectrogram_np
from .models import tacotron as taco
from .models import wavernn as wr
from .text import text_to_sequence


def tts_to_wav(tts_model: taco.Tacotron, voc_model: Optional[wr.WaveRNN],
               text: str, cfg: Config, r: int, steps: int = 2000,
               generator: Optional[torch.Generator] = None, noise=None,
               target: Optional[int] = None, overlap: Optional[int] = None,
               device="cuda", timings: Optional[dict] = None,
               batched: bool = True, sparse_packed=None,
               vocoder: str = "wavernn", gl_iters: int = 32, gl_phase_u=None):
    """Full text -> waveform with the WaveRNN vocoder, fold-batched or, with
    ``batched=False``, one unbatched row over the whole utterance; or with
    ``vocoder="griffinlim"`` through NNLS and ``gl_iters`` Griffin-Lim
    iterations on the device (``voc_model`` may then be None).

    The postnet output, rescaled [-4, 4] -> [0, 1] and clipped, conditions
    the vocoder (gen_tacotron.py:145). ``generator`` seeds the WaveRNN's
    sampling noise; ``noise`` injects it instead (replay). Griffin-Lim's
    initial phase is a fixed seed-0 draw, or ``gl_phase_u`` injected (see
    dsp/griffinlim.griffinlim). ``timings``, when given, receives
    CUDA-event records of each stage (see timing.elapsed_ms).
    Returns (wav, mel, attention) as numpy arrays."""
    if vocoder not in ("wavernn", "griffinlim"):
        raise ValueError(vocoder)
    dev = resolve_device(device, tts_model,
                         *([voc_model] if vocoder == "wavernn" else []))
    x = text_to_sequence(text.strip(), cfg.tts.cleaner_names)
    _, m, attention = taco.generate(tts_model, np.asarray(x), r, steps=steps,
                                    device=dev, timings=timings)
    m = np.clip((m + 4.0) / 8.0, 0.0, 1.0)
    if vocoder == "griffinlim":
        wav = reconstruct_waveform(m, cfg.dsp, n_iter=gl_iters, device=dev,
                                   phase_u=gl_phase_u)
        return wav, m, attention
    wav = wr.generate(voc_model, m[None], batched=batched,
                      target=cfg.voc.target if target is None else target,
                      overlap=cfg.voc.overlap if overlap is None else overlap,
                      mu_law=cfg.dsp.mu_law, noise=noise, generator=generator,
                      device=dev, timings=timings,
                      sparse_packed=sparse_packed)
    return wav.cpu().numpy(), m, attention


MEL_BUCKETS = (256, 512, 1024, 2048)


def _bucket(T_valid: int, steps: int, buckets) -> int:
    """The smallest mel-length bucket that holds ``T_valid`` frames, at most
    ``steps``: vocoder work tracks the utterance, not the decode bound."""
    return min(next((b for b in sorted(buckets) if b >= T_valid), steps),
               steps)


def _host_wav(wav, T_valid: int, hop: int):
    """The wave trimmed to its true length and faded there (the reference's
    fade, fatchord_version.py:255-258), as float32 numpy."""
    wave_valid = max(T_valid - 1, 1) * hop
    wav = np.array(wav[:wave_valid].cpu().numpy(), dtype=np.float32)
    n_fade = min(20 * hop, wave_valid)
    wav[-n_fade:] *= np.linspace(1.0, 0.0, n_fade, dtype=wav.dtype)
    return wav


def tts_to_wav_fast(tts_model: taco.Tacotron, voc_model: wr.WaveRNN,
                    text: str, cfg: Config, r: int, steps: int = 2000,
                    mel_buckets=MEL_BUCKETS,
                    generator: Optional[torch.Generator] = None, noise=None,
                    target: Optional[int] = None,
                    overlap: Optional[int] = None, device="cuda",
                    timings: Optional[dict] = None, sparse_packed=None):
    """Serving-latency text -> wav (wavernn_tpu/synthesis.py:256-311): the
    decode (B2) and the postnet stay on the device, ONE scalar (the stop
    group) comes to the host to pick the smallest mel bucket that holds
    the utterance, and the bucket-padded mel feeds ``generate_fast``
    without a tail fade; the wave is trimmed to its true length and faded
    there. Returns (wav float32 numpy, mel numpy (n_mels, T_valid))."""
    dev = resolve_device(device, tts_model, voc_model)
    steps = -(-steps // r) * r
    ids = torch.as_tensor(text_to_sequence(text.strip(),
                                           cfg.tts.cleaner_names),
                          dtype=torch.long, device=dev)[None]
    _, linear, _, n_valid = taco.generate_core(tts_model, ids, None, r, steps,
                                               timings)
    T_valid = min(int(n_valid[0]) * r, steps)          # one scalar sync
    bucket = _bucket(T_valid, steps, mel_buckets)
    # the postnet output conditions the vocoder; short utterances pad with
    # the frozen frames the decoder produced anyway
    mel01 = torch.clamp((linear[:, :, :bucket] + 4.0) / 8.0, 0.0, 1.0)
    wav = wr.generate_fast(voc_model, mel01, target=target, overlap=overlap,
                           mu_law=cfg.dsp.mu_law, noise=noise,
                           generator=generator, device=dev, tail_fade=False,
                           timings=timings, sparse_packed=sparse_packed)
    return (_host_wav(wav, T_valid, cfg.dsp.hop_length),
            mel01[0, :, :T_valid].cpu().numpy())


def tts_to_wav_batch(tts_model: taco.Tacotron, voc_model: wr.WaveRNN, texts,
                     cfg: Config, r: int, steps: int = 2000,
                     mel_buckets=MEL_BUCKETS,
                     generator: Optional[torch.Generator] = None, noise=None,
                     target: Optional[int] = None,
                     overlap: Optional[int] = None, device_out: bool = False,
                     mesh=None, device="cuda",
                     timings: Optional[dict] = None, sparse_packed=None):
    """Batched serving (wavernn_tpu/synthesis.py:127-253): N sentences ->
    one masked batched decode (B8; B2 for one sentence) with a stop per
    utterance -> one host sync of the N stop groups, each utterance's mel
    cut to its bucket -> ``generate_multi``: every utterance's folds in one
    sample-loop launch, post-processed on the device -> each wave trimmed
    to its true length and faded there.

    Returns a list of (wav float32 numpy, mel numpy (n_mels, T_valid)), or
    with ``device_out`` a list of (wav tensor on the device, trimmed but
    not faded, T_valid). ``noise`` covers the combined fold batch.

    ``mesh`` (a ``DeviceMesh``, every rank calling with the same
    arguments): the sentences split into contiguous groups, one a rank,
    each decoded by B8 (B2 for a group of one; B8 takes any batch, so no
    rank decodes pad rows, where the JAX package's mesh scan needed them);
    the mels and stop groups all-gathered, then
    ``parallel/gen_sharded.generate_multi_sharded`` over the combined fold
    batch. Every rank returns every utterance."""
    dev = resolve_device(device, tts_model, voc_model)
    steps = -(-steps // r) * r
    seqs = [text_to_sequence(t.strip(), cfg.tts.cleaner_names)
            for t in texts]
    linear, n_valid = _decode(tts_model, seqs, r, steps, timings, dev, mesh)
    n_valid = n_valid.cpu().tolist()          # one host sync of N scalars
    mels, t_valids = [], []
    for b, n in enumerate(n_valid):
        T_valid = min(n * r, steps)
        bucket = _bucket(T_valid, steps, mel_buckets)
        mels.append(torch.clamp((linear[b, :, :bucket] + 4.0) / 8.0, 0.0,
                                1.0))
        t_valids.append(T_valid)
    if mesh is None:
        wavs = wr.generate_multi(
            voc_model, mels, target=target, overlap=overlap,
            mu_law=cfg.dsp.mu_law, noise=noise, generator=generator,
            device=dev, device_out=True, tail_fade=False, timings=timings,
            sparse_packed=sparse_packed)
    else:
        from .parallel.gen_sharded import generate_multi_sharded
        wavs = generate_multi_sharded(
            voc_model, mels, mesh, target=target, overlap=overlap,
            mu_law=cfg.dsp.mu_law, noise=noise, generator=generator,
            device=dev, device_out=True, tail_fade=False, timings=timings,
            sparse_packed=sparse_packed)
    hop = cfg.dsp.hop_length
    if device_out:
        return [(w[:max(t - 1, 1) * hop], t) for w, t in zip(wavs, t_valids)]
    return [(_host_wav(w, t, hop), m[:, :t].cpu().numpy())
            for w, m, t in zip(wavs, mels, t_valids)]


def _decode(tts_model, seqs, r: int, steps: int, timings, dev, mesh):
    """(linear (N, n_mels, steps), n_valid (N,)) of the sentences: one
    batched decode, or on a mesh one a rank over its contiguous group of
    sentences, gathered on every rank."""
    if mesh is None:
        mine = seqs
    else:
        from .parallel import mesh as pm
        n, world, k = len(seqs), pm.size(mesh), pm.rank(mesh)
        lo = k * (n // world) + min(k, n % world)
        mine = seqs[lo:lo + n // world + (k < n % world)]
    if mine:
        ids, lens = taco.pad_ids(mine, dev)
        _, linear, _, n_valid = taco.generate_core(
            tts_model, ids, lens if len(mine) > 1 else None, r, steps,
            timings)
    else:   # more ranks than sentences
        linear = torch.zeros(0, tts_model.n_mels, steps, device=dev)
        n_valid = torch.zeros(0, dtype=torch.long, device=dev)
    if mesh is None:
        return linear, n_valid
    return (torch.cat(pm.all_gather_rows(linear, mesh)),
            torch.cat(pm.all_gather_rows(n_valid.to(torch.long), mesh)))


def _batch_str(batched: bool, target: int, overlap: int) -> str:
    return (f"gen_batched_target{target}_overlap{overlap}" if batched
            else "gen_NOT_BATCHED")


def gen_testset(voc_model: wr.WaveRNN, test_set, samples: int, batched: bool,
                target: int, overlap: int, save_path, cfg: Config,
                step: int = 0, generator: Optional[torch.Generator] = None,
                log=print, device="cuda", sparse_packed=None):
    """Copy-synthesis of held-out items (gen_wavernn.py:11-35): saves the
    decoded ground truth next to the model's output, generated through
    ``wavernn.generate``, fold-batched or unbatched (a sample-loop kernel
    on CUDA), under the JAX package's file names. Returns the paths of the
    generated wavs."""
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    k = step // 1000
    save_path = Path(save_path)
    out = []
    for i in range(min(samples, len(test_set))):
        m, x = test_set[i]
        log(f"| Generating: {i + 1}/{samples}")
        bits = 16 if cfg.voc.mode == "MOL" else cfg.dsp.bits
        if cfg.dsp.mu_law and cfg.voc.mode != "MOL":
            gt = decode_mu_law(x, 2 ** bits, from_labels=True)
        else:
            gt = label_2_float(x.astype(np.float64), bits)
        save_wav(gt, save_path / f"{k}k_steps_{i + 1}_target.wav",
                 cfg.dsp.sample_rate)
        wav = wr.generate(voc_model, m[None], batched=batched, target=target,
                          overlap=overlap, mu_law=cfg.dsp.mu_law,
                          generator=generator, device=device,
                          sparse_packed=sparse_packed)
        path = save_path / (f"{k}k_steps_{i + 1}_"
                            f"{_batch_str(batched, target, overlap)}.wav")
        save_wav(wav.cpu().numpy(), path, cfg.dsp.sample_rate)
        out.append(path)
    return out


def gen_from_file(voc_model: wr.WaveRNN, load_path, save_path, batched: bool,
                  target: int, overlap: int, cfg: Config, step: int = 0,
                  generator: Optional[torch.Generator] = None,
                  device="cuda", sparse_packed=None):
    """Vocode a ``.wav`` (analysed again: saved as
    ``__{name}__{k}k_steps_target.wav``, then its mel by
    ``melspectrogram_np``) or a saved [0, 1] mel ``.npy`` of shape
    (n_mels, frames) (gen_wavernn.py:38-65). Saves and returns the wave
    (float64 numpy)."""
    load_path, save_path = Path(load_path), Path(save_path)
    if load_path.suffix == ".wav":
        wav = load_wav(load_path, cfg.dsp.sample_rate)
        save_wav(wav, save_path / (f"__{load_path.stem}__{step // 1000}k_"
                                   "steps_target.wav"), cfg.dsp.sample_rate)
        mel = melspectrogram_np(wav, cfg.dsp)
    elif load_path.suffix == ".npy":
        mel = np.load(load_path)
        if mel.ndim != 2 or mel.shape[0] != cfg.dsp.num_mels:
            raise ValueError(f"Expected a numpy array shaped (n_mels, "
                             f"n_hops), got {mel.shape}")
        if mel.max() >= 1.01 or mel.min() <= -0.01:
            raise ValueError(f"Expected spectrogram range in [0,1], got "
                             f"[{mel.min()}, {mel.max()}]")
    else:
        raise ValueError(f"Expected .wav or .npy, got {load_path.suffix}")
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    wav = wr.generate(voc_model, mel[None].astype(np.float32),
                      batched=batched, target=target, overlap=overlap,
                      mu_law=cfg.dsp.mu_law, generator=generator,
                      device=device, sparse_packed=sparse_packed)
    out = wav.cpu().numpy()
    save_wav(out, save_path / (f"__{load_path.stem}__{step // 1000}k_steps_"
                               f"{_batch_str(batched, target, overlap)}.wav"),
             cfg.dsp.sample_rate)
    return out
