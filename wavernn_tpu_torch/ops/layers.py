"""Neural-net primitives as plain functions on tensors (port of
``wavernn_tpu.ops.layers``).

Weights are in torch's layouts, the reference state-dict's own: a linear
weight is (out, in), a conv weight (out, in, k), GRU/LSTM weights
(gates * hidden, in) with torch's gate order — GRU [r, z, n]
(fatchord_version.py:117-119), LSTM [i, f, g, o] (tacotron.py:220-221).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def linear(x, w, b=None):
    """x (..., in) @ w (out, in)^T + b."""
    y = x @ w.t()
    return y if b is None else y + b


def conv1d(x, w, b=None, padding: int = 0):
    """x (N, C, W) -> (N, O, W_out); w (O, C, K)."""
    return F.conv1d(x, w, b, padding=padding)


def batchnorm(x, weight, bias, mean, var, eps: float = BN_EPS):
    """Eval-mode BatchNorm1d over (N, C, W) with running statistics."""
    inv = torch.rsqrt(var + eps)
    y = (x - mean[None, :, None]) * inv[None, :, None]
    return y * weight[None, :, None] + bias[None, :, None]


def batchnorm_train(x, weight, bias, running_mean, running_var,
                    momentum: float = 0.1, eps: float = BN_EPS, mesh=None):
    """Training-mode BatchNorm1d over (N, C, W): batch statistics over
    (N, W) in float32 (float64 for float64 input), the output in x's dtype.

    The running statistics (momentum 0.1, unbiased variance) are updated
    IN PLACE in ``running_mean``/``running_var``, where the JAX package
    returns new parameters; the optimizer never reads them, so when in the
    step they change makes no difference.

    ``mesh`` (a data-parallel DeviceMesh, x this rank's shard of the
    batch): the statistics are the whole batch's, as the JAX step's over a
    batch-sharded array are. Two sums over the ranks, each differentiable
    (SyncBatchNorm's reduction, so the backward is global too): the
    per-channel sum with the count, which gives the mean, then the sum of
    squared deviations from it, which gives the variance as one process
    computes it on the whole batch. The running statistics take the
    global values."""
    in_dtype = x.dtype
    x = x.to(torch.promote_types(in_dtype, torch.float32))
    if mesh is None:
        mean = x.mean(dim=(0, 2))
        var = x.var(dim=(0, 2), unbiased=False)
        n = x.shape[0] * x.shape[2]
        denom = max(n - 1, 1)
    else:
        from ..parallel.mesh import all_reduce_sum
        C = x.shape[1]
        s = all_reduce_sum(torch.cat([x.sum(dim=(0, 2)), x.new_tensor(
            [x.shape[0] * x.shape[2]])]), mesh)
        n = s[C].detach()          # the count, kept on the device
        mean = s[:C] / n
        var = all_reduce_sum(
            ((x - mean[None, :, None]) ** 2).sum(dim=(0, 2)), mesh) / n
        denom = (n - 1).clamp_min(1)
    with torch.no_grad():
        unbiased = var * n / denom
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased)
    y = (x - mean[None, :, None]) * torch.rsqrt(var + eps)[None, :, None]
    y = y * weight[None, :, None] + bias[None, :, None]
    return y.to(in_dtype)


def gru_gates(gi, gh, h):
    """GRU update from the input- and hidden-side projections (biases
    included): n = tanh(gi_n + r * gh_n), h' = (1 - z) n + z h."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    """One GRU step. x (B, in), h (B, H) -> (B, H)."""
    return gru_gates(linear(x, w_ih, b_ih), linear(h, w_hh, b_hh), h)


def gru(xs, w_ih, w_hh, b_ih, b_hh, h0: Optional[torch.Tensor] = None,
        engine: str = "scan"):
    """Full-sequence GRU, xs (B, T, in) -> ((B, T, H), h_T).

    The input-side GEMM runs once over the whole sequence; only the
    hidden-side product is sequential. ``engine="scan"`` runs the step
    loop under autograd; any other engine runs the recurrence through
    ``ops/cuda_gru.gru_seq_tm`` time-major (the kernel B5 forward and
    backward on CUDA tensors, their plain versions on CPU tensors)."""
    B, T, _ = xs.shape
    H = w_hh.shape[1]
    h = xs.new_zeros(B, H) if h0 is None else h0
    gi_all = linear(xs, w_ih, b_ih)
    if engine != "scan":
        from .cuda_gru import gru_seq_tm
        ys = gru_seq_tm(gi_all.transpose(0, 1).contiguous(), w_hh.t(), b_hh,
                        h).transpose(0, 1)
        return ys, ys[:, -1]
    ys = []
    for t in range(T):
        h = gru_gates(gi_all[:, t], linear(h, w_hh, b_hh), h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def bigru(xs, fwd, bwd, lens: Optional[torch.Tensor] = None,
          engine: str = "scan"):
    """Bidirectional GRU: concat(fwd(x), reversed(bwd(reversed(x)))).

    ``fwd``/``bwd`` are (w_ih, w_hh, b_ih, b_hh) tuples; ``engine`` as in
    ``gru``. ``lens`` (B,) gives the true lengths of right-padded rows:
    each row is rolled right by T - len before the flip, so the backward
    GRU reads the real text first and valid positions match an unpadded
    run (pad positions are garbage for the caller to ignore)."""
    y_f, _ = gru(xs, *fwd, engine=engine)
    if lens is None:
        y_b, _ = gru(xs.flip(1), *bwd, engine=engine)
        return torch.cat([y_f, y_b.flip(1)], dim=-1)
    T = xs.shape[1]
    shifts = [int(s) for s in (T - lens).tolist()]
    rolled = torch.stack([torch.roll(x, s, dims=0)
                          for x, s in zip(xs, shifts)])
    y_b, _ = gru(rolled.flip(1), *bwd, engine=engine)
    y_b = y_b.flip(1)
    y_b = torch.stack([torch.roll(y, -s, dims=0)
                       for y, s in zip(y_b, shifts)])
    return torch.cat([y_f, y_b], dim=-1)


def lstm_cell(x, state: Tuple[torch.Tensor, torch.Tensor], w_ih, w_hh,
              b_ih, b_hh):
    """One LSTM step; state = (h, c)."""
    h, c = state
    H = h.shape[-1]
    g = linear(x, w_ih, b_ih) + linear(h, w_hh, b_hh)
    i = torch.sigmoid(g[..., :H])
    f = torch.sigmoid(g[..., H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


def dropout_mask(shape, rate: float, generator: torch.Generator, device):
    """A dropout keep-mask scaled by 1 / (1 - rate): each entry is
    1 / (1 - rate) with probability 1 - rate, else 0."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < 1.0 - rate).float() / (1.0 - rate)


def dropout(x, rate: float, training: bool, mask: torch.Tensor):
    """Inverted dropout (``wavernn_tpu/ops/layers.py:339-343``): x times
    the scaled keep-``mask`` (``dropout_mask``). Identity when not training
    or at rate 0."""
    if not training or rate == 0.0:
        return x
    return x * mask.to(x.dtype)


def embedding(ids, table):
    return table[ids]
