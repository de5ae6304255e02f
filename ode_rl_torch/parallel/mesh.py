"""The mesh: one process a rank, ranks on a 2-D grid of named axes.

Counterpart of ``ode_rl_tpu/parallel/mesh.py``. JAX builds a
``('data', 'model')`` mesh (or ``('data', 'space')``, parallel/sp.py),
shards the batch's leading axis over ``'data'``, places parameters by
``PartitionSpec``s, and GSPMD compiles the global function with every
collective inserted. In PyTorch nothing is implicit, so this module holds
the collectives the port writes by hand:

* ``make_mesh(n_data, n_model)`` reads torchrun's ``RANK``, ``WORLD_SIZE``
  and ``LOCAL_RANK`` (or takes them), binds ``cuda:LOCAL_RANK`` (or the
  CPU where the caller names it; without CUDA and without a device it
  raises) and initialises the process group: NCCL on CUDA, gloo on the CPU,
  or the backend the caller names. Without torchrun's variables the mesh
  has one rank and no process group, as JAX's ``make_mesh()`` on one chip
  has one device. Rank r sits at (r // n2, r % n2) of the (n_data, n2)
  grid; each line of each axis has its own process group, so every
  collective names its axis (``all_reduce_(t, axis)``, ``all_gather``).
* ``batch_size`` stays the global batch: data index d takes rows
  ``[d * B / n_data, (d + 1) * B / n_data)`` (``Mesh.rows``,
  ``shard_batch``).
* ``replicate`` broadcasts a module's parameters and buffers from rank 0;
  ``shard_pytree`` keeps each parameter's slice of the dimension its spec
  names (``'model'``, parallel/tp.py) and ``gather_pytree`` joins the
  slices back. ``Mesh.all_reduce_grads`` averages a replicated leaf's
  gradient over every rank and a sharded leaf's over its ``'data'`` line,
  in one flat buffer a dtype each.
* Inside ``with mesh:`` (the train steps enter it) the model's terms that
  mix rows of the batch are global: ``global_sum``, ``global_mean`` and
  ``world()`` sum over the axes that split the activations, ``'data'``
  and ``'space'`` and never ``'model'`` (the activations are replicated
  over ``'model'``: a sum there would count them twice, and the ranks
  would still agree, so nothing would show it); ``gather_rows``
  all-gathers rows over ``'data'``. Each has its gradient.

A rank's loss is its share of the global loss: the global loss is the
mean of the shares of the ranks that split the activations, and the
gradients are averaged. A term that every rank computes from the same
all-reduced values (a free-bits clamp of a global mean) is counted once
by that mean, and the all-reduce's backward sums the ranks' gradients
into it, which the average divides back. Under ``'model'`` every rank of
a line computes the line's whole loss: a column-parallel layer's
backward sums its input's partial gradients over the line and keeps
this rank's channels of its output's (parallel/tp.py), so a replicated
leaf's gradient is whole on every rank of the line.

Every collective takes the tensors where they lie: NCCL on CUDA, gloo on
the CPU, and gloo on CUDA where a caller names it (two ranks sharing one
card), which takes CUDA tensors for the all-reduce, the all-gather and
the broadcast (``dryrun.gloo_device_probe`` checks it on the card).

The step's code runs under autograd, which on CUDA runs a backward on a
thread of its own: the entered mesh is this thread's, so every Function
whose backward communicates keeps its mesh in its ``ctx``, and a
backward that replays a forward (the O(NFE) dopri5, a remat'd attempt)
enters the mesh of its forward again.
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
SPACE_AXIS = "space"
# The axes along which the activations are split (summed over by
# ``global_sum``); ``'model'`` replicates them.
SPLIT = "split"

# The entered mesh, of this thread: a step enters it around its forward
# and backward, and a collective's backward carries its mesh itself, so
# autograd's device threads need not see it.
_LOCAL = threading.local()


class Mesh:
    """The ranks of a ``('data', axis)`` grid, as this process sees them.

    ``axes`` maps the two axis names to their sizes, ``'data'`` first
    (``{'data': world}`` by default); ``groups`` the process group of this
    rank's line of each axis that does not span every rank."""

    def __init__(self, rank: int = 0, world: int = 1,
                 device: torch.device = torch.device("cpu"),
                 backend: Optional[str] = None,
                 axes: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = backend
        self.axes = dict(axes or {DATA_AXIS: world})
        names = list(self.axes)
        if names[0] != DATA_AXIS or len(names) > 2 or any(
                n not in (MODEL_AXIS, SPACE_AXIS) for n in names[1:]):
            raise ValueError(f"mesh axes {names}: 'data', then 'model' or "
                             "'space'")
        n = 1
        for size in self.axes.values():
            n *= size
        if n != world:
            raise ValueError(f"mesh {self.axes} does not cover {world} "
                             "ranks")
        self.groups = dict(groups or {})
        self.grad_bytes = 0      # bytes of the last gradient all-reduce
        # Bytes this rank sent into collectives, by the axis each named
        # ('all': every rank; 'split': 'data' x 'space'): all-reduced, or
        # given to an all-gather.
        self.moved: Dict[str, int] = {}

    @property
    def shape(self) -> Dict[str, int]:
        if len(self.axes) == 1:
            return {DATA_AXIS: self.world, MODEL_AXIS: 1}
        return dict(self.axes)

    @property
    def distributed(self) -> bool:
        """Whether a process group carries the collectives."""
        return self.backend is not None

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return self.axes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        inner = self.world // self.size(DATA_AXIS)
        if axis == DATA_AXIS:
            return self.rank // inner
        return self.rank % inner if axis in self.axes else 0

    @property
    def split_world(self) -> int:
        """Ranks that split the activations: ``'data'`` x ``'space'``."""
        return self.size(DATA_AXIS) * self.size(SPACE_AXIS)

    def _span(self, axis: Optional[str]) -> Optional[str]:
        """The axis a collective over ``axis`` runs on: None for every
        rank, else the name of a line's group."""
        if axis == SPLIT:
            axis = DATA_AXIS if self.size(MODEL_AXIS) > 1 else None
        if axis is None or self.size(axis) == self.world:
            return None
        return axis

    def _group(self, axis: Optional[str]):
        span = self._span(axis)
        return None if span is None else self.groups[span]

    def _trivial(self, axis: Optional[str]) -> bool:
        span = self._span(axis)
        return not self.distributed or (span is not None
                                        and self.size(span) == 1)

    # -- rows -------------------------------------------------------------
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (its ``'data'``
        index's)."""
        n_data = self.size(DATA_AXIS)
        if n % n_data:
            raise ValueError(f"the global batch {n} does not split over "
                             f"{n_data} ranks")
        per = n // n_data
        d = self.index(DATA_AXIS)
        return slice(d * per, (d + 1) * per)

    # -- collectives (no autograd) ----------------------------------------
    def all_reduce_(self, t: torch.Tensor,
                    axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` in place over ``axis`` (every rank where None;
        ``SPLIT``: the axes that split the activations)."""
        if not self._trivial(axis):
            self._count(axis, t)
            dist.all_reduce(t, group=self._group(axis))
        return t

    def _count(self, axis: Optional[str], t: torch.Tensor) -> None:
        key = axis or "all"
        self.moved[key] = (self.moved.get(key, 0)
                           + t.numel() * t.element_size())

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
        """The ``t`` of the ranks along ``axis`` concatenated along
        ``dim`` in their order."""
        if self._trivial(axis):
            return t
        t = t.contiguous()
        self._count(axis, t)
        span = self._span(axis)
        n = self.world if span is None else self.size(span)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._group(axis))
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
        """Average the ``.grad`` of ``params``: a replicated leaf's over
        every rank, a leaf sharded over ``'model'`` (``tp_dim``) over its
        ``'data'`` line; one all-reduce a dtype each, the gradients
        flattened in the order given. ``grad_bytes`` keeps the bytes
        all-reduced."""
        params = [p for p in params if p.grad is not None]
        if not self.distributed or not params:
            return
        moved = 0
        for axis, n in ((None, self.world),
                        (DATA_AXIS, self.size(DATA_AXIS))):
            grads = [p.grad for p in params
                     if (getattr(p, "tp_dim", None) is None) == (axis is None)]
            for dtype in sorted({g.dtype for g in grads}, key=str):
                group = [g for g in grads if g.dtype == dtype]
                flat = torch.cat([g.reshape(-1) for g in group])
                self.all_reduce_(flat, axis)
                if n > 1:
                    flat.div_(n)
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


def _line_groups(world: int, n_data: int, axis: str, backend: str
                 ) -> Dict[str, object]:
    """This rank's process group of each line of the (n_data, world /
    n_data) grid, ``'data'`` lines first; every rank creates every group,
    in the same order, as ``new_group`` asks."""
    inner = world // n_data
    rank = dist.get_rank()
    groups = {}
    lines = {DATA_AXIS: [[d * inner + m for d in range(n_data)]
                         for m in range(inner)],
             axis: [[d * inner + m for m in range(inner)]
                    for d in range(n_data)]}
    for name, members in lines.items():
        if len(members[0]) in (1, world):
            continue
        for ranks in members:
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[name] = group
    return groups


def grid_mesh(base: Mesh, axis: str, n: int) -> Mesh:
    """The ``('data', axis)`` mesh of ``n`` ranks along ``axis`` over the
    ranks and process group of ``base`` (a collective: every rank calls
    it, in the same order)."""
    if base.world % n:
        raise ValueError(f"{base.world} ranks do not split into lines of "
                         f"{n} along {axis!r}")
    n_data = base.world // n
    groups = (_line_groups(base.world, n_data, axis, base.backend)
              if base.distributed else {})
    return Mesh(base.rank, base.world, base.device, base.backend,
                {DATA_AXIS: n_data, axis: n}, groups)


def _init(backend: Optional[str], device: Optional[torch.device],
          init_method: Optional[str], rank: Optional[int],
          world_size: Optional[int], n_ranks: Optional[int],
          timeout: datetime.timedelta) -> Mesh:
    """The process group of this process (torchrun's variables where the
    caller names none), as a mesh of one ``'data'`` axis."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if world_size is None and n_ranks not in (None, 1):
        raise ValueError(f"a mesh of {n_ranks} ranks needs a process "
                         "group: launch with torchrun")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device for this rank's cuda:"
                f"{local_rank}; pass device=torch.device(\"cpu\") for a "
                "mesh on the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world_size is None:
        return Mesh(0, 1, device, None)
    if n_ranks is not None and n_ranks != world_size:
        raise ValueError(f"a mesh of {n_ranks} ranks does not cover "
                         f"{world_size} ranks")
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


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              backend: Optional[str] = None,
              device: Optional[torch.device] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: datetime.timedelta = datetime.timedelta(minutes=10)
              ) -> Mesh:
    """The ``('data', 'model')`` mesh of this process: ``n_model`` ranks
    a ``'model'`` line (tensor-parallel parameters, parallel/tp.py),
    ``n_data`` (every rank over ``n_model`` by default) along ``'data'``.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE`` (``init_method`` to ``env://``, its store); without
    them the mesh has one rank and no process group. The device defaults
    to ``cuda:LOCAL_RANK`` and raises a RuntimeError where CUDA is not
    available (a mesh on the CPU is asked for with
    ``device=torch.device("cpu")``); the backend defaults to NCCL on CUDA
    and gloo on the CPU."""
    return _grid(MODEL_AXIS, n_data, n_model, backend, device, init_method,
                 rank, world_size, timeout)


def _grid(axis: str, n_data: Optional[int], n: int, backend, device,
          init_method, rank, world_size, timeout) -> Mesh:
    if n < 1:
        raise ValueError(f"{axis} axis of {n} ranks")
    n_ranks = None if n_data is None else n_data * n
    no_group = world_size is None and "WORLD_SIZE" not in os.environ
    if n > 1 and no_group:  # before the device: the arguments' fault first
        raise ValueError(f"a mesh of {n} ranks along {axis!r} needs a "
                         "process group: launch with torchrun")
    base = _init(backend, device, init_method, rank, world_size, n_ranks,
                 timeout)
    if n == 1:
        return base
    if base.world == 1:
        raise ValueError(f"a mesh of {n} ranks along {axis!r} needs a "
                         "process group: launch with torchrun")
    return grid_mesh(base, axis, n)


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


@torch.no_grad()
def shard_pytree(module: torch.nn.Module, mesh: Mesh,
                 specs: Dict[str, tuple]) -> torch.nn.Module:
    """Keep, of each parameter whose spec (a tuple of one axis name or
    None a dimension, as a ``PartitionSpec``) names ``'model'``, this
    rank's slice of that dimension; the parameter remembers it
    (``tp_dim``, ``tp_size``: the whole dimension). Every other
    parameter stays whole, and the module that holds a sharded one notes
    it (``tp_dims``: leaf name -> dimension), so its forward knows even
    where a functional call swaps other tensors in. The optimizer's
    state must not exist yet."""
    n, m = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    for name, p in list(module.named_parameters()):
        spec = tuple(specs.get(name) or ())
        named = [(d, a) for d, a in enumerate(spec) if a is not None]
        if not named:
            continue
        if named != [(named[0][0], MODEL_AXIS)] or len(spec) != p.ndim:
            raise ValueError(f"{name}: spec {spec} for shape "
                             f"{tuple(p.shape)}; parameters shard one "
                             "dimension over 'model'")
        dim = named[0][0]
        size = p.shape[dim]
        if size % n:
            raise ValueError(f"{name}: {size} does not split over {n}")
        p.data = p.data.narrow(dim, m * (size // n), size // n).clone()
        p.tp_dim, p.tp_size = dim, size
        prefix, _, leaf = name.rpartition(".")
        holder = module.get_submodule(prefix)
        holder.tp_dims = {**getattr(holder, "tp_dims", {}), leaf: dim}
    return module


def gather_pytree(module: torch.nn.Module, mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every ``'model'``-sharded parameter
    gathered whole (a collective over the ``'model'`` lines)."""
    state = dict(module.state_dict())
    for name, p in module.named_parameters():
        dim = getattr(p, "tp_dim", None)
        if dim is not None:
            state[name] = mesh.all_gather(p.detach(), dim, MODEL_AXIS)
    return state


# -- terms that mix rows, inside ``with mesh:`` -----------------------------

def current() -> Optional[Mesh]:
    """The entered mesh of this thread, of any size, else None."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def active() -> Optional[Mesh]:
    """The entered mesh of more than one rank, else None."""
    mesh = current()
    return None if mesh is None or mesh.world == 1 else mesh


def axis_mesh(axis: str) -> Optional[Mesh]:
    """The entered mesh where it has more than one rank along ``axis``."""
    mesh = active()
    return mesh if mesh is not None and mesh.size(axis) > 1 else None


def world() -> int:
    """Ranks that split the activations (``'data'`` x ``'space'``)."""
    mesh = active()
    return 1 if mesh is None else mesh.split_world


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``axis``; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(), ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """Concatenate the ranks' rows along ``axis``; the backward sums the
    ranks' gradients and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis, ctx.n = mesh, dim, axis, x.shape[dim]
        return mesh.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.contiguous().clone(), ctx.axis)
        i = ctx.mesh.index(ctx.axis or DATA_AXIS)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: Optional[str]
                   ) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``axis``, with its gradient."""
    return _AllReduceSum.apply(x, mesh, axis)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the activations (with its
    gradient) inside an entered mesh; ``x`` itself otherwise."""
    mesh = active()
    return x if mesh is None else _AllReduceSum.apply(x, mesh, SPLIT)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the ranks that split the
    activations (equal shards); ``x.mean()`` on one rank."""
    mesh = active()
    if mesh is None:
        return x.mean()
    return (_AllReduceSum.apply(x.sum(), mesh, SPLIT)
            / (x.numel() * mesh.split_world))


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every ``'data'`` rank's rows of ``x`` along ``dim``, in rank order
    (with the gradient back to each rank's own); ``x`` itself on one
    rank."""
    mesh = active()
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return x
    axis = DATA_AXIS if mesh.world > mesh.size(DATA_AXIS) else None
    return _AllGather.apply(x, mesh, dim, axis)
