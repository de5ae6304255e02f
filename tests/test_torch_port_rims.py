"""The RIMs (nn/rims.py) in the port against ``ode_rl_tpu/nn/rims.py``,
module by module: ``blocked_grad``, ``sparse_topk_renorm``,
``topk_active_mask`` (ties go to the lowest index, as ``lax.top_k``),
``GroupLinear``, ``BlockMultiHeadAttention``, ``BlockGRUCell``,
``BlocksCore`` and ``RIM`` (two layers), ``BlockConvGRUCell``,
``ConvBlocksCore`` and ``ConvRIM``, with and without the sparse
inter-block communication, in training mode with dropout 0 on both sides
(JAX draws its masks from its 'dropout' rng, the port from its
generator: they cannot share bits). Then, the port alone: dropout keeps
a share 1 - p of the elements, scales them by 1 / (1 - p), and draws a
fresh mask at every step from the generator.

Tolerances and the harness as tests/test_torch_port_s3vae_nets.py:
outputs in fp32 to 1e-5 max abs, gradients in fp64 on both sides to 1e-6
relative L2 plus 1e-9 of the whole norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, t32
from test_torch_port_s3vae_nets import module_parity
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.nn import rims

B = 3


def _gen():
    return torch.Generator().manual_seed(0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_blocked_grad_matches_jax():
    from ode_rl_tpu.nn.rims import blocked_grad as jax_bg

    x, mask = _rand(B, 4, seed=1), (_rand(B, 4, seed=2) > 0).astype(
        np.float32)
    w = _rand(B, 4, seed=3)
    j = jax.grad(lambda v: jnp.sum(jax_bg(v, jnp.asarray(mask)) * w))(
        jnp.asarray(x))
    leaf = t32(x).requires_grad_(True)
    out = rims.blocked_grad(leaf, t32(mask))
    assert torch.equal(out, t32(x))
    torch.sum(out * t32(w)).backward()
    assert np.array_equal(np32(leaf.grad), np32(j))


@pytest.mark.parametrize("top_k,t", [(1, 5), (2, 5), (3, 4), (4, 4)])
def test_sparse_topk_renorm_matches_jax(top_k, t):
    from ode_rl_tpu.nn.rims import sparse_topk_renorm as jax_sparse

    attn = np.abs(_rand(B, 2, t, seed=4))
    attn /= attn.sum(-1, keepdims=True)
    ours = rims.sparse_topk_renorm(t32(attn), top_k)
    assert max_abs(ours, jax_sparse(jnp.asarray(attn), top_k)) <= 1e-7


def test_topk_active_mask_breaks_ties_by_lowest_index():
    """Rows of tied null attention: the active blocks are the lowest
    entries, ties to the lowest index, as JAX's ``lax.top_k``; exactly
    ``topkval`` ones a row."""
    from ode_rl_tpu.nn.rims import topk_active_mask as jax_mask

    rows = np.array([[0.2, 0.2, 0.2, 0.4], [0.5, 0.1, 0.1, 0.1],
                     [0.25, 0.25, 0.25, 0.25], [0.3, 0.1, 0.3, 0.1]],
                    np.float32)
    rows = np.concatenate([rows, np.abs(_rand(4, 4, seed=5))])
    for topk in (1, 2, 3, 4):
        ours = rims.topk_active_mask(t32(rows), topk)
        ref = np32(jax_mask(jnp.asarray(rows), topk))
        assert np.array_equal(np32(ours), ref), topk
        assert np.all(np32(ours).sum(-1) == min(topk, 4))
    assert np.array_equal(np32(rims.topk_active_mask(t32(rows[:3]), 2)),
                          [[1, 1, 0, 0], [0, 1, 1, 0], [1, 1, 0, 0]])


def test_group_linear_matches_jax():
    from ode_rl_tpu.nn.rims import GroupLinear as JaxGL

    module_parity(JaxGL(din=5, dout=3, num_blocks=4),
                  rims.GroupLinear(5, 3, 4, generator=_gen()),
                  [_rand(B, 4, 5, seed=6)], lambda m, x, noise: m(x))


@pytest.mark.parametrize("residual,skip_write,topk", [
    (True, False, 1), (False, True, 3), (False, False, 2)])
def test_block_attention_matches_jax(residual, skip_write, topk):
    """Outputs (and the attention weights) in fp32 to 1e-3 max abs: with
    few keys kept, the renormalisation divides by a sum of differences of
    near weights (an output of 0.998 lay 1.3e-4 from JAX's)."""
    from ode_rl_tpu.nn.rims import BlockMultiHeadAttention as JaxAtt

    kw = dict(n_head=2, d_model_read=6, d_model_write=5, d_model_out=8,
              d_k=4, d_v=3, num_blocks_read=3, num_blocks_write=4,
              topk=topk, residual=residual, skip_write=skip_write,
              dropout=0.0)
    q, k, v = (_rand(B, n, d, seed=7 + i)
               for i, (n, d) in enumerate([(3, 6), (4, 5), (4, 5)]))
    port = rims.BlockMultiHeadAttention(
        *[kw[a] for a in ("n_head", "d_model_read", "d_model_write",
                          "d_model_out", "d_k", "d_v", "num_blocks_read",
                          "num_blocks_write", "topk")],
        residual=residual, skip_write=skip_write, dropout=0.0,
        generator=_gen())
    module_parity(JaxAtt(**kw), port, [q, k, v],
                  lambda m, q, k, v, noise: m(q, k, v, True, noise),
                  call_kw={"train": True}, out_tol=1e-3)


def test_block_gru_cell_matches_jax():
    from ode_rl_tpu.nn.rims import BlockGRUCell as JaxCell

    module_parity(JaxCell(ninp=12, nhid=9, k=3),
                  rims.BlockGRUCell(12, 9, 3, generator=_gen()),
                  [_rand(B, 12, seed=10), _rand(B, 9, seed=11)],
                  lambda m, x, h, noise: m(x, h))


@pytest.mark.parametrize("sparse_comm", [False, True])
def test_blocks_core_matches_jax(sparse_comm):
    from ode_rl_tpu.nn.rims import BlocksCore as JaxCore

    module_parity(
        JaxCore(ninp=6, n_hid=12, num_blocks_in=1, num_blocks_out=4,
                topkval=2, sparse_comm=sparse_comm, dropout=0.0),
        rims.BlocksCore(6, 12, 1, 4, 2, sparse_comm=sparse_comm,
                        dropout=0.0, generator=_gen()),
        [_rand(B, 6, seed=12), _rand(B, 12, seed=13)],
        lambda m, x, h, noise: m(x, h, True, noise),
        call_kw={"train": True})


@pytest.mark.parametrize("use_blocked_grad", [False, True])
def test_rim_matches_jax(use_blocked_grad):
    """Two layers over time, from zeros, in training mode."""
    from ode_rl_tpu.nn.rims import RIM as JaxRIM

    kw = dict(n_hid=[12, 8], num_blocks=[4, 2], topk=[2, 1])
    module_parity(
        JaxRIM(ninp=5, use_blocked_grad=use_blocked_grad, dropout=0.0,
               **kw),
        rims.RIM(5, kw["n_hid"], kw["num_blocks"], kw["topk"],
                 use_blocked_grad=use_blocked_grad, dropout=0.0,
                 generator=_gen()),
        [_rand(B, 4, 5, seed=14)],
        lambda m, xs, noise: m(xs, train=True, noise=noise),
        call_kw={"train": True})


def test_block_conv_gru_cell_matches_jax():
    from ode_rl_tpu.nn.rims import BlockConvGRUCell as JaxCell

    port = rims.BlockConvGRUCell(8, 4, generator=_gen())
    assert port.gates.weight.shape == (16, 4, 3, 3) and port.gates.groups == 4
    module_parity(JaxCell(nhid=8, k=4), port,
                  [_rand(B, 5, 5, 8, seed=15), _rand(B, 5, 5, 8, seed=16)],
                  lambda m, x, h, noise: m(x, h))


@pytest.mark.parametrize("sparse_comm", [False, True])
def test_conv_blocks_core_matches_jax(sparse_comm):
    from ode_rl_tpu.nn.rims import ConvBlocksCore as JaxCore

    module_parity(
        JaxCore(in_ch=3, n_hid=8, num_blocks_out=4, topkval=3,
                sparse_comm=sparse_comm, dropout=0.0),
        rims.ConvBlocksCore(3, 8, 4, 3, sparse_comm=sparse_comm,
                            dropout=0.0, generator=_gen()),
        [_rand(B, 4, 4, 3, seed=17), _rand(B, 4, 4, 8, seed=18)],
        lambda m, x, h, noise: m(x, h, True, noise),
        call_kw={"train": True})


def test_conv_rim_matches_jax():
    from ode_rl_tpu.nn.rims import ConvRIM as JaxRIM

    module_parity(JaxRIM(in_ch=3, n_hid=8, num_blocks=4, topk=3,
                         dropout=0.0),
                  rims.ConvRIM(3, 8, 4, 3, dropout=0.0, generator=_gen()),
                  [_rand(B, 3, 4, 4, 3, seed=19)],
                  lambda m, xs, noise: m(xs, train=True, noise=noise),
                  call_kw={"train": True})


def test_dropout_keeps_a_share_and_scales():
    """Training mode draws from the generator: a share 1 - p kept, each
    kept element scaled by 1 / (1 - p); a fresh mask at every call, the
    same masks from the same seed; none in eval mode."""
    x = torch.ones(200_000)
    noise = Noise(torch.Generator().manual_seed(3))
    for p in (0.1, 0.5):
        y = noise.dropout(x, p)
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - p)) < 5e-3
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert not torch.equal(noise.dropout(x, 0.5), noise.dropout(x, 0.5))
    assert torch.equal(noise.dropout(x, 0.0), x)

    rim = rims.RIM(5, [12], [3], [3], generator=_gen())
    xs = torch.from_numpy(_rand(B, 4, 5, seed=20))
    runs = [rim(xs, train=True,
                noise=Noise(torch.Generator().manual_seed(s)))[0]
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # Per step, a share about 1 - 0.5 of the outputs is zeroed.
    assert 0.3 < float((runs[0] == 0).float().mean()) < 0.7
    assert torch.equal(rim(xs, train=False)[0], rim(xs, train=False)[0])
