"""The data-parallel mesh: one process a rank, the batch split over them.

Counterpart of the data-parallel half of ``ode_rl_tpu/parallel/mesh.py``.
JAX builds a ``('data', 'model')`` mesh, shards the batch's leading axis
over ``'data'`` and replicates the parameters; GSPMD then compiles the
global function and inserts every collective. In PyTorch nothing is
implicit, so this module holds the collectives the port writes by hand:

* ``make_mesh`` reads torchrun's ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK``, binds ``cuda:LOCAL_RANK`` (or the CPU) and initialises
  the process group: NCCL on CUDA, gloo on the CPU, or the backend the
  caller names. Without torchrun's variables the mesh has one rank and
  no process group, as JAX's ``make_mesh()`` on one chip has one device.
* ``batch_size`` stays the global batch: rank r takes rows
  ``[r * B / N, (r + 1) * B / N)`` (``Mesh.rows``, ``shard_batch``).
* ``replicate`` broadcasts a module's parameters and buffers from rank 0;
  ``Mesh.all_reduce_grads`` averages every gradient over the ranks in one
  flat buffer a dtype, in the parameters' order.
* Inside ``with mesh:`` (the train steps enter it) the model's terms that
  mix rows of the batch are global: ``global_sum``, ``global_mean`` and
  ``gather_rows`` all-reduce or all-gather with gradients, so every rank
  computes its share of the unsharded step.

A rank's loss is its share of the global loss: the global loss is the
mean of the ranks' losses, and the gradients are averaged. A term that
every rank computes from the same all-reduced values (a free-bits clamp
of a global mean) is counted once by that mean, and the all-reduce's
backward sums the ranks' gradients into it, which the average divides
back.

Every collective takes the tensors where they lie: NCCL on CUDA, gloo on
the CPU, and gloo on CUDA where a caller names it (two ranks sharing one
card), which takes CUDA tensors for the all-reduce, the all-gather and
the broadcast (``dryrun.gloo_device_probe`` checks it on the card).

Not ported: the ``'model'`` axis (``make_mesh(n_model>1)``,
``shard_pytree``; ROADMAP queue 1, item 13) and the ``'space'`` axis
(``make_sp_mesh``, ``shard_batch_sp``; item 14). Each raises, naming its
item.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
TP_ITEM = "ROADMAP queue 1, item 13 (TP)"
SP_ITEM = "ROADMAP queue 1, item 14 (SP)"

# The entered mesh, of this thread: a step enters it around its forward
# and backward, and a collective's backward carries its mesh itself, so
# autograd's device threads need not see it.
_LOCAL = threading.local()


class Mesh:
    """The ranks of the ``'data'`` axis, as this process sees them."""

    def __init__(self, rank: int = 0, world: int = 1,
                 device: torch.device = torch.device("cpu"),
                 backend: Optional[str] = None):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = backend
        self.grad_bytes = 0      # bytes of the last gradient all-reduce

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world, MODEL_AXIS: 1}

    @property
    def distributed(self) -> bool:
        """Whether a process group carries the collectives."""
        return self.backend is not None

    # -- rows -------------------------------------------------------------
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"the global batch {n} does not split over "
                             f"{self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- collectives (no autograd) ----------------------------------------
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.distributed:
            dist.all_reduce(t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if not self.distributed:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.distributed:
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        elif self.distributed:
            dist.barrier()

    # -- the step's gradients and metrics ---------------------------------
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Average the ``.grad`` of ``params`` over the ranks: one
        all-reduce a dtype, the gradients flattened in the order given.
        ``grad_bytes`` keeps the bytes all-reduced."""
        grads = [p.grad for p in params if p.grad is not None]
        if not self.distributed or not grads:
            return
        moved = 0
        for dtype in sorted({g.dtype for g in grads}, key=str):
            group = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in group])
            self.all_reduce_(flat)
            if self.world > 1:
                flat.div_(self.world)
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            moved += flat.numel() * flat.element_size()
        self.grad_bytes = moved

    def mean_metrics(self, metrics: Dict) -> Dict:
        """Tensor metrics averaged over the ranks in one all-reduce (fp64
        on the wire); other values are the same on every rank and pass."""
        keys = [k for k, v in metrics.items()
                if torch.is_tensor(v) and v.numel() == 1]
        if self.world == 1 or not keys:
            return metrics
        vals = torch.stack([metrics[k].detach().reshape(()).double()
                            for k in keys])
        self.all_reduce_(vals)
        vals /= self.world
        out = dict(metrics)
        for k, v in zip(keys, vals):
            out[k] = v.to(metrics[k].dtype)
        return out

    # -- the active mesh ---------------------------------------------------
    def __enter__(self) -> "Mesh":
        _LOCAL.stack = getattr(_LOCAL, "stack", []) + [self]
        return self

    def __exit__(self, *exc) -> None:
        _LOCAL.stack = _LOCAL.stack[:-1]


def entered(mesh: Optional[Mesh]):
    """``mesh`` entered, or nothing where there is none."""
    return contextlib.nullcontext() if mesh is None else mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              backend: Optional[str] = None,
              device: Optional[torch.device] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: datetime.timedelta = datetime.timedelta(minutes=10)
              ) -> Mesh:
    """The ``('data', 'model')`` mesh of this process.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE`` (``init_method`` to ``env://``, its store); without
    them the mesh has one rank and no process group. The device defaults
    to ``cuda:LOCAL_RANK`` where CUDA is available, else the CPU; the
    backend to NCCL on CUDA and gloo on the CPU."""
    if n_model != 1:
        raise NotImplementedError(
            f"the 'model' axis (n_model={n_model}) is not ported: {TP_ITEM}")
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        device = (torch.device("cuda", local_rank)
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world_size is None:
        if n_data not in (None, 1):
            raise ValueError(f"a mesh of {n_data} ranks needs a process "
                             "group: launch with torchrun")
        return Mesh(0, 1, device, None)
    if n_data is not None and n_data != world_size:
        raise ValueError(f"mesh {n_data}x1 does not cover {world_size} "
                         "ranks")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(f"{local_world} NCCL ranks on this host but "
                             f"{cards} visible cards: NCCL needs a card a "
                             "rank (name backend='gloo' to share one)")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    return Mesh(rank, world_size, device, backend)


def shard_batch(batch: Dict, mesh: Mesh, n: Optional[int] = None) -> Dict:
    """The rank's rows of every tensor whose leading axis is the batch's
    (``n`` rows, by default ``observed_data``'s); shared tensors
    (timestamps) whole."""
    n = batch["observed_data"].shape[0] if n is None else n
    rows = mesh.rows(n)
    return {k: (v[rows] if torch.is_tensor(v) and v.ndim >= 1
                and v.shape[0] == n else v)
            for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0."""
    for t in list(module.parameters()) + list(module.buffers()):
        mesh.broadcast_(t.data)
    return module


def shard_pytree(*_args, **_kwargs):
    raise NotImplementedError(f"explicit parameter shardings (the 'model' "
                              f"axis) are not ported: {TP_ITEM}")


# -- terms that mix rows, inside ``with mesh:`` -----------------------------

def active() -> Optional[Mesh]:
    """The entered mesh of more than one rank, else None."""
    stack = getattr(_LOCAL, "stack", None)
    mesh = stack[-1] if stack else None
    return None if mesh is None or mesh.world == 1 else mesh


def world() -> int:
    mesh = active()
    return 1 if mesh is None else mesh.world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


class _AllGather(torch.autograd.Function):
    """Concatenate the ranks' rows; the backward sums the ranks'
    gradients and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.contiguous().clone())
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (with its gradient) inside an entered
    mesh; ``x`` itself otherwise."""
    mesh = active()
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the ranks (equal shards);
    ``x.mean()`` on one rank."""
    mesh = active()
    if mesh is None:
        return x.mean()
    return _AllReduceSum.apply(x.sum(), mesh) / (x.numel() * mesh.world)


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, in rank order (with the
    gradient back to each rank's own); ``x`` itself on one rank."""
    mesh = active()
    return x if mesh is None else _AllGather.apply(x, mesh, dim)
