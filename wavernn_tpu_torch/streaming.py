"""Streaming vocoder synthesis: incremental mel -> waveform with bounded
latency (port of ``wavernn_tpu.streaming``).

The reference generates whole utterances only (fatchord_version.py:169-264).
For live serving this wraps the materialized sample loop's state I/O
(``ops/cuda_gen.generate_materialized``, the kernel B3 on CUDA) into a push
API:

    voc = StreamingVocoder(model, device="cuda")
    for mel_chunk in frontend:          # (n_mels, k) frames, any k
        wav_so_far = voc.feed(mel_chunk)   # float32 samples, may be empty
    tail = voc.flush()

Exactness: the upsampler's receptive field is ±``voc.pad`` mel frames, so
conditioning for frames [i, i+k) computed from the window [i-pad, i+k+pad)
equals the whole-utterance computation, and the RNN state handoff between
blocks is exact. Under the same injected noise the streamed samples equal
one unbatched offline run of the sample loop.

Blocks may be any number of samples. The JAX package refuses blocks that
are a multiple of 128 samples on its kernel, whose 128-step chunk padding
left no room for the state snapshot; the port's kernel returns the state
after exactly the block's steps, so any ``chunk_frames`` works.

Latency: ``pad`` frames of lookahead (2 frames = 25 ms at hop 275 /
22.05 kHz) plus one ``chunk_frames`` block of compute.

A block-pruned model streams through B3's sparse arm: pass
``sparse_packed=cuda_gen.pack_sparse(model.core_weights(), ...)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.wavernn import WaveRNN, mu_law_decode
from .ops.cuda_gen import generate_materialized


def _as_noise(noise, dev):
    if noise is None:
        return None
    if isinstance(noise, (tuple, list)):
        return tuple(torch.as_tensor(u, dtype=torch.float32, device=dev)
                     for u in noise)
    return torch.as_tensor(noise, dtype=torch.float32, device=dev)


def _noise_rows(u, start: int, T: int, col=None):
    """Steps [start, start + T) of one noise tensor (optionally one column),
    padded with the neutral 0.5 past its end."""
    u = u[start:start + T] if col is None else u[start:start + T, col]
    if u.shape[0] < T:
        pad = u.new_full((T - u.shape[0],) + tuple(u.shape[1:]), 0.5)
        u = torch.cat([u, pad])
    return u


class _Blocks:
    """What both vocoders share: the model, its device, and one block =
    window upsample -> the materialized sample loop resuming from the
    carried state."""

    def __init__(self, model: WaveRNN, chunk_frames: int, mu_law: bool,
                 noise, generator, device, device_out: bool,
                 sparse_packed=None):
        self.model = model
        self._sparse = sparse_packed
        self.dev = resolve_device(device, model)
        self.voc, self.dsp = model.voc, model.dsp
        self.chunk_frames = chunk_frames
        self.T = chunk_frames * self.dsp.hop_length
        self.mu_law = mu_law and self.voc.mode == "RAW"
        self._noise = _as_noise(noise, self.dev)
        self._gen = generator
        self._device_out = device_out

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.dev)

    def _seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._gen)
                   .item())

    @torch.no_grad()
    def _block(self, windows, state, noise, lanes=None):
        """windows (B, n_mels, chunk_frames + 2*pad) -> samples (B, T) and
        the state after the block's last step. ``lanes`` (a
        ``parallel/mesh.FoldShard`` of the B lanes): this rank runs its
        lanes (``state`` holds theirs) and gathers every lane's samples;
        the windows are upsampled whole, as on one device, so each lane's
        conditioning is the one-device block's."""
        mels_up, aux = self.model.upsample(windows)
        seed = 0 if noise is not None else self._seed()
        if lanes is None:
            return generate_materialized(
                self.model.core_weights(), mels_up, aux, self.voc.mode,
                noise=noise, seed=seed, init_state=state,
                sparse_packed=self._sparse)
        from .parallel.mesh import same_seed
        samples, new = generate_materialized(
            self.model.core_weights(), lanes.take(mels_up, 0),
            lanes.take(aux, 0), self.voc.mode, noise=lanes.noise(noise),
            seed=same_seed(seed, lanes.mesh), init_state=state,
            sparse_packed=self._sparse, **lanes.rows())
        return lanes.gather(samples), new

    def _emit(self, y):
        """One block's samples of one stream as the caller gets them."""
        if self._device_out:
            return (mu_law_decode(y, self.voc.n_classes(self.dsp.bits))
                    if self.mu_law else y)
        if self.mu_law:
            y = mu_law_decode(y.double(), self.voc.n_classes(self.dsp.bits))
        return y.float().cpu().numpy()

    def _mels(self, mel_chunk):
        return torch.as_tensor(np.asarray(mel_chunk, np.float32)
                               if not torch.is_tensor(mel_chunk)
                               else mel_chunk, dtype=torch.float32,
                               device=self.dev)

    def _join(self, outs):
        if self._device_out:
            return outs
        if outs:
            return np.concatenate(outs)
        return np.zeros((0,), np.float32)


class StreamingVocoder(_Blocks):
    """Incremental WaveRNN synthesis with exact offline parity.

    Processes fixed-size blocks of ``chunk_frames`` mel frames. ``feed``
    buffers frames and returns whatever audio became ready; ``flush``
    drains the remainder (right-padding the final window with ``pad`` zero
    frames, the offline path's symmetric padding).

    noise: optional injected sampling noise for replay — MOL: (u_mix
    (T, 1, nr_mix), u_s (T, 1)); RAW: (T, 1, n_classes) — consumed
    sequentially across blocks. Without it each block draws counter-hash
    noise from a seed taken from ``generator``.

    device_out=True: ``feed``/``flush`` return a list of float32 tensors on
    the device (one per completed block, possibly empty), mu-law decoded
    there, instead of one host array, so a serving loop can enqueue the
    next block while this one's audio is still in flight.

    sparse_packed: ``cuda_gen.pack_sparse`` of a block-pruned model's
    weights; every block runs B3's sparse arm (B9).
    """

    def __init__(self, model: WaveRNN, chunk_frames: int = 24,
                 mu_law: bool = True, noise=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", device_out: bool = False,
                 sparse_packed=None):
        super().__init__(model, chunk_frames, mu_law, noise, generator,
                         device, device_out, sparse_packed)
        self._noise_at = 0
        # mel buffer starts with the offline path's left padding
        self._buf = self._zeros(self.dsp.num_mels, self.voc.pad)
        self._state = None   # (h1, h2, x) after the last emitted sample
        self._done = False

    def _take_noise(self):
        if self._noise is None:
            return None
        s = self._noise_at
        self._noise_at += self.T
        if isinstance(self._noise, tuple):
            return tuple(_noise_rows(u, s, self.T) for u in self._noise)
        return _noise_rows(self._noise, s, self.T)

    def _run_block(self, window):
        if self._state is None:
            R = self.voc.rnn_dims
            self._state = (self._zeros(1, R), self._zeros(1, R),
                           self._zeros(1))
        samples, self._state = self._block(window[None], self._state,
                                           self._take_noise())
        return self._emit(samples[0])

    def _drain(self):
        """Emit every complete block in the buffer."""
        W = self.chunk_frames + 2 * self.voc.pad
        outs, start = [], 0
        while self._buf.shape[1] - start >= W:
            outs.append(self._run_block(self._buf[:, start:start + W]))
            start += self.chunk_frames
        # frames left of the next window are never read again: the buffer
        # holds the left context plus pending frames, not the stream
        self._buf = self._buf[:, start:]
        return outs

    def feed(self, mel_chunk):
        """Append (n_mels, k) mel frames; return the newly ready samples
        (a host array, or a list of device tensors with device_out)."""
        assert not self._done, "flush() already called"
        self._buf = torch.cat([self._buf, self._mels(mel_chunk)], dim=1)
        return self._join(self._drain())

    def flush(self):
        """Right-pad with ``pad`` zero frames and emit the remaining audio;
        the final short block is zero-padded to a full window and its
        emission trimmed."""
        assert not self._done, "flush() already called"
        self._done = True
        pad = self.voc.pad
        self._buf = torch.cat([self._buf,
                               self._zeros(self.dsp.num_mels, pad)], dim=1)
        outs = self._drain()
        rem = self._buf.shape[1] - 2 * pad
        if rem > 0:
            w = torch.nn.functional.pad(
                self._buf, (0, self.chunk_frames + 2 * pad
                            - self._buf.shape[1]))
            outs.append(self._run_block(w)[: rem * self.dsp.hop_length])
        return self._join(outs)


class MultiStreamVocoder(_Blocks):
    """B concurrent streams through ONE sample-loop launch per block.

    Streams progress independently: each has its own mel buffer; a block
    runs whenever at least one stream has a full window. Streams without a
    full window ride along with zero conditioning and have their RNN state
    restored afterwards, so lagging sessions never corrupt, and never
    block, the rest. With injected ``noise``, a stream's audio equals
    running it alone with its noise column at the same block boundaries.

        msv = MultiStreamVocoder(model, n_streams=8)
        ready = msv.feed(b, mel_chunk)      # {stream: samples} newly ready
        ready = msv.flush(b)                # finish b; dict incl. its tail

    noise: optional per-stream injected noise — MOL: (u_mix (T, B, nr_mix),
    u_s (T, B)); RAW: (T, B, n_classes). Each stream consumes its column at
    its own sample position. Without it each block draws counter-hash noise
    from a seed taken from ``generator``; every lane gets its own draws.

    device_out=True: results are lists of device tensors (one per block)
    instead of host arrays (see StreamingVocoder). ``sparse_packed``: as in
    StreamingVocoder.

    ``mesh`` (a ``DeviceMesh``; every rank makes the same calls): the lanes
    are sharded over the ranks, ``n_streams`` a multiple of the world size
    as the JAX package requires (wavernn_tpu/streaming.py:337-344). Each
    rank holds every lane's mel buffer but only its own lanes' RNN state,
    runs B3 with its state arm on its lanes (the counter hash's rows set
    to theirs, so every lane draws its one-device numbers), and gathers
    every lane's samples: each rank returns every stream's audio. The JAX
    package runs the scan on a mesh; the port runs the kernel.
    """

    def __init__(self, model: WaveRNN, n_streams: int, chunk_frames: int = 24,
                 mu_law: bool = True, noise=None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", device_out: bool = False,
                 sparse_packed=None, mesh=None):
        super().__init__(model, chunk_frames, mu_law, noise, generator,
                         device, device_out, sparse_packed)
        self.n_streams = n_streams
        self._lanes = None
        lo, n_local = 0, n_streams
        if mesh is not None:
            from .parallel.mesh import FoldShard, size
            if n_streams % size(mesh):
                raise ValueError(
                    f"n_streams={n_streams} must be a multiple of the mesh's "
                    f"{size(mesh)} ranks; round up and leave the extra "
                    "lanes unused (they ride state-frozen)")
            self._lanes = FoldShard(n_streams, mesh)
            lo, n_local = self._lanes.row0, self._lanes.per
        self._local = range(lo, lo + n_local)   # the lanes whose state is here
        R = self.voc.rnn_dims
        self._state = (self._zeros(n_local, R), self._zeros(n_local, R),
                       self._zeros(n_local))
        # per-stream mel buffer: starts with the offline left padding
        self._bufs = [self._zeros(self.dsp.num_mels, self.voc.pad)
                      for _ in range(n_streams)]
        self._noise_at = [0] * n_streams    # per-stream sample position
        self._done = [False] * n_streams
        self._flushed = [False] * n_streams  # tail block already emitted

    def _window_len(self):
        return self.chunk_frames + 2 * self.voc.pad

    def _block_noise(self, active):
        """(T, B, ...) replay noise from the per-stream positions; inactive
        lanes get the neutral 0.5."""
        if self._noise is None:
            return None

        def stack(u):
            cols = [_noise_rows(u, self._noise_at[b], self.T, b) if active[b]
                    else u.new_full((self.T,) + tuple(u.shape[2:]), 0.5)
                    for b in range(self.n_streams)]
            return torch.stack(cols, dim=1)

        if isinstance(self._noise, tuple):
            return tuple(stack(u) for u in self._noise)
        return stack(self._noise)

    def _run_block(self, windows, active):
        """windows (B, n_mels, W), active: list of bool. One batched block;
        the state of inactive lanes is restored."""
        noise = self._block_noise(active)
        samples, new = self._block(windows, self._state, noise, self._lanes)
        keep = torch.tensor([active[b] for b in self._local], device=self.dev)
        self._state = tuple(torch.where(keep.reshape((-1,) + (1,) * (n.dim()
                                                                     - 1)),
                                        n, o)
                            for n, o in zip(new, self._state))
        for b in range(self.n_streams):
            if active[b]:
                self._noise_at[b] += self.T
        return samples

    def _drain(self):
        """Run blocks while any stream has a full window; emit per stream."""
        W = self._window_len()
        outs: dict = {}
        while True:
            active = [self._bufs[b].shape[1] >= W and not self._flushed[b]
                      for b in range(self.n_streams)]
            if not any(active):
                break
            windows = self._zeros(self.n_streams, self.dsp.num_mels, W)
            for b in range(self.n_streams):
                if active[b]:
                    windows[b] = self._bufs[b][:, :W]
            samples = self._run_block(windows, active)
            for b in range(self.n_streams):
                if active[b]:
                    self._bufs[b] = self._bufs[b][:, self.chunk_frames:]
                    outs.setdefault(b, []).append(self._emit(samples[b]))
        return {b: self._join(ys) for b, ys in outs.items()}

    def feed(self, stream: int, mel_chunk, drain: bool = True):
        """Append (n_mels, k) frames to ``stream``; run any ready blocks.
        Returns {stream: newly ready samples} across all streams.
        ``drain=False`` only buffers: a serving loop that receives frames
        for several sessions in one tick feeds them all, then ``poll``s
        once, so every ready lane shares each block."""
        assert not self._done[stream], f"stream {stream} already flushed"
        self._bufs[stream] = torch.cat([self._bufs[stream],
                                        self._mels(mel_chunk)], dim=1)
        return self._drain() if drain else {}

    def poll(self):
        """Run every block that became ready since the last drain."""
        return self._drain()

    def flush(self, stream: int):
        """Finish ``stream``: right-pad with ``pad`` zero frames and emit its
        remaining audio. Returns a {stream: samples} dict like ``feed``
        (the drain may complete blocks other streams were waiting on)."""
        assert not self._done[stream], f"stream {stream} already flushed"
        self._done[stream] = True
        pad = self.voc.pad
        self._bufs[stream] = torch.cat(
            [self._bufs[stream], self._zeros(self.dsp.num_mels, pad)], dim=1)
        outs = self._drain()
        parts = outs.get(stream)
        parts = ([] if parts is None else list(parts) if self._device_out
                 else [parts])
        rem = self._bufs[stream].shape[1] - 2 * pad
        if rem > 0:
            windows = self._zeros(self.n_streams, self.dsp.num_mels,
                                  self._window_len())
            w = self._bufs[stream]
            windows[stream, :, :w.shape[1]] = w
            active = [b == stream for b in range(self.n_streams)]
            samples = self._run_block(windows, active)
            parts.append(self._emit(samples[stream][: rem
                                                    * self.dsp.hop_length]))
        self._flushed[stream] = True
        self._bufs[stream] = self._bufs[stream][:, :0]
        outs[stream] = self._join(parts)
        return outs

    def reset(self, stream: int):
        """Recycle a lane for a new session: zero its state rows, restart its
        mel buffer at the offline left padding, clear its bookkeeping. The
        other lanes are untouched."""
        if stream in self._local:
            for s in self._state:
                s[stream - self._local.start] = 0.0
        self._bufs[stream] = self._zeros(self.dsp.num_mels, self.voc.pad)
        self._noise_at[stream] = 0
        self._done[stream] = False
        self._flushed[stream] = False
