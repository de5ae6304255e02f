"""parallel/ in the port, in one process: the mesh at one rank,
``shard_batch`` on every key
of ``make_batch_dict``, the global draws (each rank's draws are rows of
the one-process draws), and the terms that mix rows of the batch on a
fake two-rank group: two threads, each a rank, exchanging tensors. Each
term (dopri5's error norm, BatchNorm's moments, the free-bits clamp and
S3VAE's negatives and MI) is held against the one-process formula on the
whole batch, and its rank-local version (the call site's collectives
swapped for their one-rank versions) is shown to miss it by more than
the tolerance on the same inputs. The gradient all-reduce averages.
Last, two processes building the kernel library at once on a stub
compiler build it once.

Tolerances: fp32 sums in another order (a rank sums its rows, then the
ranks' sums are added), 1e-6 relative for single terms and their
gradients averaged over the ranks 1e-4 relative L2 of the one-process
gradient; the whole S3VAE model runs in fp64 (its loss terms take
fp32, as the port's loss casts them), the loss 1e-6 and the gradients
1e-8 (reading 2.1e-10).
"""

import contextlib
import copy
import os
import pathlib
import stat
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_s3vae import f64_batch, port_f64
from ode_rl_torch import parallel
from ode_rl_torch.core.noise import GlobalRows, Noise
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models import s3vae
from ode_rl_torch.models.s3vae import S3VAEModel
from ode_rl_torch.nn import norm
from ode_rl_torch.nn.norm import BatchNorm
from ode_rl_torch.ode import solvers
from ode_rl_torch.ode.solvers import _rms_norm, odeint_aux
from ode_rl_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from ode_rl_torch.wm import rssm as rssm_module
from ode_rl_torch.wm.rssm import RSSM

REPO = pathlib.Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


# ----------------------------- the fake group -------------------------------

class ThreadGroup:
    """Ranks as threads of this process: a collective posts each rank's
    tensor, waits for all, and reads them in rank order."""

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world, timeout=60)
        self.slots = [None] * world

    def exchange(self, rank: int, t: torch.Tensor) -> list:
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


class ThreadMesh(Mesh):
    def __init__(self, group: ThreadGroup, rank: int):
        super().__init__(rank, group.world, torch.device("cpu"), "threads")
        self.group = group

    def all_reduce_(self, t, axis=None):
        parts = self.group.exchange(self.rank, t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return t.copy_(total)

    def all_gather(self, t, dim=0, axis=None):
        return torch.cat(self.group.exchange(self.rank, t), dim=dim)

    def broadcast_(self, t, src=0):
        return t.copy_(self.group.exchange(self.rank, t)[src])

    def barrier(self):
        self.group.barrier.wait()


def on_ranks(fn, world: int = 2) -> list:
    """``fn(mesh)`` on ``world`` thread ranks, each inside its mesh;
    returns their results in rank order."""
    group = ThreadGroup(world)
    out, errors = [None] * world, []

    def body(rank):
        try:
            with ThreadMesh(group, rank) as mesh:
                out[rank] = fn(mesh)
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


# ------------------------------- the mesh ----------------------------------

def test_mesh_at_one_rank(monkeypatch):
    from ode_rl_tpu.parallel import mesh as jax_mesh
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh(device=torch.device("cpu"))
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)
    assert mesh.shape == {"data": 1, "model": 1}
    assert (parallel.DATA_AXIS, parallel.MODEL_AXIS) == (
        jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS)
    assert mesh.device == torch.device("cpu")
    assert mesh.rows(8) == slice(0, 8)
    assert Mesh(rank=2, world=4).rows(8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split over 4"):
        Mesh(rank=0, world=4).rows(6)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(n_data=2)


def test_mesh_without_cuda_raises_unless_the_cpu_is_named(monkeypatch):
    """``make_mesh()`` takes cuda:LOCAL_RANK and raises where there is no
    CUDA, rather than build a mesh on the CPU nobody asked for; the CPU
    is named with ``device``. (Here there is no CUDA; the check is made
    not to depend on that.)"""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"device=torch.device\("):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_sp_mesh(n_space=1)
    assert make_mesh(device=torch.device("cpu")).device.type == "cpu"


def test_shard_batch_takes_rows_of_every_batch_key():
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    video = torch.rand((8, 6, 64, 64, 1)) - 0.5
    batch = make_batch_dict(video, n_in=3, with_flow_labels=True)
    assert set(batch) == set(jax_batch(jnp.zeros((8, 6, 64, 64, 1)), n_in=3,
                                       with_flow_labels=True))
    rows = shard_batch(batch, Mesh(rank=1, world=4))
    assert set(rows) == set(batch)
    for k, v in batch.items():
        if v.ndim >= 1 and v.shape[0] == 8:
            assert torch.equal(rows[k], v[2:4]), k
        else:
            assert rows[k] is v, k          # timestamps stay whole


# ------------------------------ global draws -------------------------------

DRAWS = {
    "normal": lambda n, s: n.normal(s, torch.zeros(())),
    "gumbel": lambda n, s: n.gumbel(s, torch.zeros(())),
    "uniform": lambda n, s: n.uniform(s, torch.device("cpu"), -1.0, 2.0),
    "randint": lambda n, s: n.randint(0, 7, s, torch.device("cpu")),
    "dropout": lambda n, s: n.dropout(torch.ones(s), 0.3),
}


@pytest.mark.parametrize("kind", sorted(DRAWS))
def test_global_draws_are_rows_of_the_one_process_draws(kind):
    draw = DRAWS[kind]
    whole = draw(Noise(torch.Generator().manual_seed(3)), (8, 5))
    for rank in range(4):
        ours = draw(GlobalRows(Noise(torch.Generator().manual_seed(3)), rank,
                               4), (2, 5))
        assert torch.equal(ours, whole[2 * rank:2 * rank + 2]), rank


def test_global_draws_on_another_axis_in_blocks_and_permutations():
    gen = lambda: Noise(torch.Generator().manual_seed(4))
    like = torch.zeros(())
    # Time-first (T, B, D): the batch on axis 1.
    whole = gen().normal((3, 8, 2), like)
    ours = GlobalRows(gen(), 1, 2).normal_at((3, 4, 2), like, batch_axis=1)
    assert torch.equal(ours, whole[:, 4:])
    # Three batches stacked on axis 0 (S3VAE's anchor, positive, negative).
    whole = gen().normal((3 * 8, 2), like).reshape(3, 8, 2)
    ours = GlobalRows(gen(), 1, 2).in_blocks(3).normal((3 * 4, 2), like)
    assert torch.equal(ours.reshape(3, 4, 2), whole[:, 4:])
    # Permutations are drawn whole, then the same on every rank.
    assert torch.equal(GlobalRows(gen(), 1, 2).permutation(8, "cpu"),
                       gen().permutation(8, "cpu"))


# ------------------------- terms that mix rows ------------------------------

# The one-rank versions of the collectives a module imports.
ONE_RANK = {"global_sum": lambda x: x, "global_mean": lambda x: x.mean(),
            "gather_rows": lambda x, dim=0: x, "world": lambda: 1,
            "active": lambda: None}


@contextlib.contextmanager
def rank_local(module):
    """``module``'s terms on each rank's rows alone: the collectives it
    calls swapped for their one-rank versions while the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in ONE_RANK.items():
            if hasattr(module, name):
                mp.setattr(module, name, fn)
        yield

def test_rms_norm_on_two_ranks_is_the_global_norm():
    x = torch.randn((4, 3, 5), generator=torch.Generator().manual_seed(0))
    x[2:] *= 40.0
    whole = _rms_norm(x)
    ranks = on_ranks(lambda m: _rms_norm(x[m.rows(4)]))
    assert all(rel(r, whole) <= 1e-6 for r in ranks)
    with rank_local(solvers):
        local = on_ranks(lambda m: _rms_norm(x[m.rows(4)]))
    assert all(rel(r, whole) > 1e-3 for r in local)


def test_dopri5_takes_the_one_process_steps_only_with_the_global_norm():
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    k = torch.tensor([1.0, 1.5, 30.0, 40.0]).reshape(4, 1)
    y0 = torch.ones((4, 3))

    def solve(rows):
        return odeint_aux(lambda t, y: -k[rows] * y, y0[rows], ts,
                          method="dopri5", rtol=1e-3, atol=1e-4,
                          max_steps=64)

    ys, stats = solve(slice(0, 4))
    for r, (ys_r, st) in enumerate(on_ranks(lambda m: solve(m.rows(4)))):
        assert st == stats
        assert rel(ys_r, ys[:, 2 * r:2 * r + 2]) <= 1e-6
    with rank_local(solvers):
        local = on_ranks(lambda m: solve(m.rows(4))[1])
    assert any(st.nfe != stats.nfe for st in local)


def _bn_case():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 6, 3), generator=gen)
    x[2:] = 3.0 * x[2:] + 2.0
    w = torch.randn((4, 6, 3), generator=gen)

    def run(mesh, rows):
        bn = BatchNorm(3)
        with torch.no_grad():
            bn.scale.copy_(torch.tensor([1.0, 0.5, 2.0]))
        xi = x[rows].clone().requires_grad_(True)
        out = bn(xi, train=True)
        loss = torch.mean(out * w[rows])
        loss.backward()
        grads = torch.cat([bn.scale.grad, bn.bias.grad])
        if mesh is not None:
            mesh.all_reduce_(grads)
            grads /= mesh.world
        return out.detach(), bn.mean.clone(), bn.var.clone(), grads, xi.grad

    whole = run(None, slice(0, 4))
    ranks = on_ranks(lambda m: run(m, m.rows(4)))
    return whole, ranks


def test_batchnorm_on_two_ranks_takes_the_global_moments():
    (out, mean, var, grads, gx), ranks = _bn_case()
    for r, (o, m, v, g, gxr) in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        assert rel(o, out[rows]) <= 1e-6
        assert rel(m, mean) <= 1e-6 and rel(v, var) <= 1e-6
        assert rel(g, grads) <= 1e-4
        # The input's gradient is the rank's rows of it (x 2 ranks: each
        # rank's loss is a mean over its rows).
        assert rel(gxr / 2, gx[rows]) <= 1e-4


def test_batchnorm_with_rank_local_moments_misses():
    with rank_local(norm):
        (out, mean, _, _, _), ranks = _bn_case()
    assert all(rel(o, out[2 * r:2 * r + 2]) > 1e-2
               for r, (o, *_rest) in enumerate(ranks))
    assert all(rel(m, mean) > 1e-2 for _, m, *_rest in ranks)


def _free_bits_case():
    gen = torch.Generator().manual_seed(2)
    rssm = RSSM(4, stoch=3, deter=5, hidden=5,
                generator=torch.Generator().manual_seed(0))
    scale = torch.tensor([0.2, 0.2, 3.0, 3.0]).reshape(4, 1, 1)
    post = {"mean": (scale * torch.randn((4, 2, 3), generator=gen)),
            "std": torch.full((4, 2, 3), 0.5)}
    prior = {"mean": torch.zeros((4, 2, 3)), "std": torch.ones((4, 2, 3))}
    kl = rssm._kl(post, prior)
    # Between the two ranks' mean KLs: clamped on the first alone.
    free = float(kl.mean())

    def run(rows):
        mean = post["mean"][rows].clone().requires_grad_(True)
        p = {"mean": mean, "std": post["std"][rows]}
        q = {k: v[rows] for k, v in prior.items()}
        loss, _ = rssm.kl_loss(p, q, free=free)
        loss.backward()
        return loss.detach(), mean.grad

    return run(slice(0, 4)), on_ranks(lambda m: run(m.rows(4)))


def test_free_bits_clamp_the_global_mean():
    (loss, grad), ranks = _free_bits_case()
    # The clamp of the global mean is the same on every rank, so the mean
    # over the ranks is the one-process loss; the rank's gradient is the
    # rows of the one-process gradient of the loss counted once a rank.
    assert all(rel(l, loss) <= 1e-6 for l, _ in ranks)
    for r, (_, g) in enumerate(ranks):
        assert rel(g / 2, grad[2 * r:2 * r + 2]) <= 1e-5


def test_free_bits_of_rank_local_means_miss():
    with rank_local(rssm_module):
        (loss, _), ranks = _free_bits_case()
    mean_loss = sum(float(l) for l, _ in ranks) / 2
    assert abs(mean_loss - float(loss)) > 1e-3 * abs(float(loss))


def _s3vae_case():
    """One S3VAE loss and its gradients in fp64 (its fp32 gradients
    through training-mode BatchNorm are ill-conditioned:
    tests/test_torch_port_s3vae.py), on the whole batch and on two
    ranks."""
    model = port_f64(S3VAEModel(in_channels=1, d_zf=8, d_zt=4,
                                encoder_out_dims=8, extrapolate=True,
                                generator=torch.Generator().manual_seed(0)))
    video = torch.rand((4, 4, 64, 64, 1),
                       generator=torch.Generator().manual_seed(5)) - 0.5
    video[2:] = video[2:] * 0.2
    batch = f64_batch(make_batch_dict(video, n_in=2, with_flow_labels=True))

    def run(mesh):
        m = copy.deepcopy(model)
        m.train()
        noise = Noise(torch.Generator().manual_seed(6))
        b = batch
        if mesh is not None:
            b = shard_batch(batch, mesh)
            noise = GlobalRows(noise, mesh.rank, mesh.world)
        loss, _ = m.loss(b, noise)
        loss.backward()
        grads = torch.cat([p.grad.reshape(-1) for p in m.parameters()])
        if mesh is not None:
            mesh.all_reduce_(grads)
            grads /= mesh.world
        return loss.detach(), grads

    return run(None), on_ranks(run)


def test_s3vae_loss_on_two_ranks_is_the_one_process_loss():
    (loss, grads), ranks = _s3vae_case()
    mean_loss = sum(float(l) for l, _ in ranks) / 2
    assert abs(mean_loss - float(loss)) <= 1e-6 * abs(float(loss))
    assert all(rel(g, grads) <= 1e-8 for _, g in ranks)


@pytest.mark.parametrize("term", ["s3vae", "batchnorm"])
def test_s3vae_with_a_rank_local_term_misses(term):
    with rank_local({"s3vae": s3vae, "batchnorm": norm}[term]):
        (loss, _), ranks = _s3vae_case()
    mean_loss = sum(float(l) for l, _ in ranks) / 2
    assert abs(mean_loss - float(loss)) > 1e-3 * abs(float(loss))


def test_gradient_all_reduce_averages_each_dtype():
    """Every rank ends with the mean of the ranks' gradients, one flat
    all-reduce a dtype; a parameter without a gradient keeps none."""
    def run(mesh):
        r = float(mesh.rank + 1)
        params = [torch.nn.Parameter(torch.zeros(3)),
                  torch.nn.Parameter(torch.zeros(2, dtype=torch.float64)),
                  torch.nn.Parameter(torch.zeros(2, 2)),
                  torch.nn.Parameter(torch.zeros(1))]
        for p, scale in zip(params[:3], (1.0, 10.0, 100.0)):
            p.grad = torch.full_like(p, scale * r)
        mesh.all_reduce_grads(params)
        return [p.grad for p in params], mesh.grad_bytes

    for grads, moved in on_ranks(run, world=4):
        # The ranks' gradients r = 1..4 times the scale: mean 2.5 x scale.
        for g, scale in zip(grads[:3], (1.0, 10.0, 100.0)):
            assert torch.equal(g, torch.full_like(g, 2.5 * scale))
        assert grads[3] is None
        assert moved == (3 + 4) * 4 + 2 * 8


# ------------------------------ the build lock ------------------------------

STUB_NVCC = """#!{python}
import pathlib, sys, time
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
pathlib.Path(out).write_bytes(b"stub")
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes that build at once on a stub nvcc: one compiles each
    source and links once; both end with the one library and nothing
    else in the build directory but the lock."""
    from ode_rl_torch.ops import _build

    bin_dir, build_dir, log = (tmp_path / "bin", tmp_path / "build",
                               tmp_path / "nvcc.log")
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    code = ("import pathlib, sys\n"
            "import ode_rl_torch.ops._build as b\n"
            "b.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "b.build()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              cwd=REPO, env=env) for _ in range(2)]
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    calls = log.read_text().splitlines()
    n_cu = sum(1 for p in _build.sources() if p.suffix == ".cu")
    assert sum(" -c " in f" {c} " for c in calls) == n_cu
    assert sum("-shared" in c for c in calls) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [".lock", _build.library_path().name])
