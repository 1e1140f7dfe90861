"""Multi-device bring-up and the collectives of the port's mesh paths (the
counterpart of ``wavernn_tpu/parallel/mesh.py``).

PyTorch's idiom replaces the JAX package's single-controller SPMD: one
process per GPU, launched by ``torchrun`` (``scripts/torchrun_train.sh``),
joined in a ``torch.distributed`` process group (NCCL on CUDA, gloo on the
CPU), and ``mesh=`` is a ``torch.distributed.device_mesh.DeviceMesh`` with
one dimension named ``"data"``. Every rank runs the hand-written kernels on
its own shard: a slice of the training batch, of a fold batch, of a
sentence batch or of the stream lanes. The entry points that take
``mesh=`` are called by every rank with the same arguments.

The batch rule differs from the JAX package's. There a host drives several
devices and ``training_mesh`` picks the largest divisor of the batch that
fits the device count; here a rank is the JAX package's *host* with one
device, so the host rule applies: the global batch must divide by the
world size, else ``training_mesh`` raises (``wavernn_tpu/cli/
train_wavernn.py:58-60``).

Transport: NCCL takes CUDA tensors in place. gloo takes host tensors (its
CUDA support covers only some collectives, and no point-to-point), so the
helpers below stage a CUDA tensor through host memory for gloo only: two
ranks that share one card (``chip_smoke.py``'s mesh phase) exchange their
shards that way. This is transport, not a CPU fallback: the compute stays
on the card.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Sequence

import torch
import torch.distributed as dist

AXIS = "data"
# how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU
    over gloo when ``device`` asks for it. A single process (no
    ``WORLD_SIZE`` above 1) joins nothing and gets ``device`` itself."""
    want = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return want
    if want.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, timeout=TIMEOUT, **kw)
    return dev


def make_mesh():
    """The 1-D ``DeviceMesh`` named ``"data"`` over every rank of the
    initialized process group."""
    cuda = dist.get_backend() == "nccl"
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if cuda else "cpu",
                            (dist.get_world_size(),), mesh_dim_names=(AXIS,))


def training_mesh(global_batch: int):
    """The data-parallel mesh for a global batch: None for a single
    process, else ``make_mesh()``. Raises unless the batch divides by the
    world size (each rank takes an equal contiguous slice)."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if global_batch % world:
        raise ValueError(f"the global batch {global_batch} does not divide "
                         f"over {world} ranks")
    return make_mesh()


def check(mesh) -> None:
    """Raise unless ``mesh`` is a 1-D DeviceMesh with a "data" dimension."""
    from torch.distributed.device_mesh import DeviceMesh
    if not (isinstance(mesh, DeviceMesh) and mesh.ndim == 1
            and mesh.mesh_dim_names == (AXIS,)):
        raise TypeError(f"mesh must be a 1-D torch.distributed DeviceMesh "
                        f"with one dimension named {AXIS!r}, got {mesh!r}")


def size(mesh) -> int:
    return mesh.size()


def rank(mesh) -> int:
    return mesh.get_local_rank(AXIS)


def _group(mesh):
    return mesh.get_group(AXIS)


def _staged(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where the backend takes it: on the host for gloo, on this
    rank's card for NCCL (an optimizer's host-side step counter)."""
    nccl = dist.get_backend(_group(mesh)) == "nccl"
    if t.is_cuda and not nccl:
        return t.cpu()
    if nccl and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    x = _staged(t, mesh)
    dist.all_reduce(x, group=_group(mesh))
    if x is not t:
        t.copy_(x)
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Average every tensor over the ranks, in place, through one flat
    buffer (one collective for the whole gradient)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    all_reduce_(flat, mesh)
    flat /= size(mesh)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose backward sums the gradients over the
    ranks too (every rank runs its backward)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (SyncBatchNorm's
    reduction)."""
    return _AllReduceSum.apply(x, mesh)


def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Overwrite every tensor with rank ``src``'s, in place."""
    for t in tensors:
        x = _staged(t, mesh)
        dist.broadcast(x, dist.get_global_rank(_group(mesh), src),
                       group=_group(mesh))
        if x is not t:
            t.copy_(x)


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim 0
    in rank order."""
    x = _staged(t.contiguous(), mesh)
    parts = [torch.empty_like(x) for _ in range(size(mesh))]
    dist.all_gather(parts, x, group=_group(mesh))
    return torch.cat(parts).to(t.device)


def all_gather_rows(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every rank's rows, whose count along dim 0 may differ by rank (zero
    included): each pads to the largest count, the counts are gathered too,
    and the padding is cut away. Returns one tensor per rank, in rank
    order; the other dims must agree."""
    n = t.new_tensor([t.shape[0]], dtype=torch.int64)
    counts = all_gather(n, mesh).tolist()
    most = max(counts)
    pad = t.new_zeros((most - t.shape[0],) + tuple(t.shape[1:]))
    full = all_gather(torch.cat([t, pad]), mesh)
    return [full[i * most:i * most + c] for i, c in enumerate(counts)]


def send_to_next(t: torch.Tensor, mesh) -> torch.Tensor:
    """Rank r's ``t`` arrives at rank r + 1; rank 0 gets zeros (the last
    rank's goes nowhere). The collective permute of the JAX package's
    exact-seam state roll, as point-to-point sends."""
    g, r, n = _group(mesh), rank(mesh), size(mesh)
    x = _staged(t.contiguous(), mesh)
    buf = torch.zeros_like(x)
    ops = []
    if r + 1 < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, r + 1),
                              g))
    if r > 0:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(g, r - 1), g))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return buf.to(t.device)


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh``; nothing without one."""
    if mesh is not None:
        dist.barrier(group=_group(mesh))


def replicate_(module: torch.nn.Module, mesh, optimizer=None) -> None:
    """Make the module's parameters and buffers (and the optimizer's state
    tensors, where it has any) rank 0's on every rank."""
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    if optimizer is not None:
        for state in optimizer.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
    broadcast_(tensors, mesh)


def set_batchnorm_mesh(module: torch.nn.Module, mesh) -> None:
    """Every BatchNorm1d in ``module`` normalises on the statistics of the
    whole batch across the mesh in training (``ops/layers.
    batchnorm_train``), as the JAX step's statistics over a batch-sharded
    array are global; None: on this process's batch."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.mesh = mesh


class FoldShard:
    """A fold batch of ``n`` rows split over the mesh (every rank's slice
    padded to ``per`` rows, rank r's the rows [r*per, (r+1)*per)), or, with
    no mesh, the whole batch on this process. The pad rows are the JAX
    package's (gen_sharded.py:344-352): zero conditioning, injected noise
    0.5, their samples cut away."""

    def __init__(self, n: int, mesh=None):
        if mesh is not None:
            check(mesh)
        self.n, self.mesh = n, mesh
        self.row0, self.per, self.pad = 0, n, 0
        if mesh is not None:
            self.per = -(-n // size(mesh))
            self.row0 = rank(mesh) * self.per
            self.pad = self.per * size(mesh) - n

    def take(self, x: torch.Tensor, dim: int, fill: float = 0.0):
        """This rank's rows of x's fold axis ``dim``, contiguous (as the
        kernels read them)."""
        if self.mesh is None:
            return x
        short = self.row0 + self.per - x.shape[dim]
        if short > 0:
            shape = list(x.shape)
            shape[dim] = short
            x = torch.cat([x, x.new_full(shape, fill)], dim)
        return x.narrow(dim, self.row0, self.per).contiguous()

    def noise(self, noise):
        """This rank's columns of injected noise (T, n, ...), or a tuple
        of such, or None."""
        if noise is None:
            return None
        if isinstance(noise, (tuple, list)):
            return tuple(self.take(u, 1, 0.5) for u in noise)
        return self.take(noise, 1, 0.5)

    def rows(self) -> dict:
        """The counter hash's rows of this rank's launch (``row0``,
        ``B_global``): every rank draws the one-device batch's numbers."""
        return {"row0": self.row0, "B_global": self.n}

    def gather(self, samples: torch.Tensor) -> torch.Tensor:
        """Every rank's samples (per, T), in fold order, the pad rows cut
        away: the whole batch's (n, T) on every rank."""
        if self.mesh is None:
            return samples
        return all_gather(samples, self.mesh)[:self.n]

    def stats(self) -> dict:
        """The fold layout (``last_stats``): devices, pad folds, folds a
        shard and the share of padding."""
        return {"num_folds": self.n,
                "devices": 1 if self.mesh is None else size(self.mesh),
                "pad_folds": self.pad, "folds_per_shard": self.per,
                "fold_imbalance": round(self.pad / max(self.n, 1), 4)}


def same_seed(seed: int, mesh) -> int:
    """The counter hash's seed, rank 0's on every rank of ``mesh``."""
    if mesh is None:
        return seed
    check(mesh)
    t = torch.tensor([seed], dtype=torch.int64)
    broadcast_([t], mesh)
    return int(t.item())
