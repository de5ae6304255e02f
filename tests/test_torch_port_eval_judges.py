"""The evaluation models of the port against the JAX package: the Moving
MNIST judge, the Sprites judge, the IMPALA CNN, the labelled generator
and the disagreement scores.

* ``quadrant_labels`` and ``generate_moving_mnist_labeled``: JAX's
  labelled batch (its positions and sprite indices recomputed from its
  key's draws) against the port's trajectories and renderer, bit for bit;
  the port's labelled batch is its unlabelled one from the same draws.
* ``MMNISTJudge`` (64x64 frames, the (8, 8, 64) map ``fc_m`` flattens in
  NHWC order), ``SpriteJudge`` and ``ImpalaCNN`` (maps 12x12, 9x13 and
  7x10: even, odd and mixed sides, with and without the Dense head) from
  JAX's init through ``convert.py``: outputs to 1e-5 relative L2 (1e-4
  for the Impala head after four residual blocks), every parameter's
  gradient of sum(outputs * w) to 1e-4 relative L2 (fp32 sums
  reassociated between XLA:CPU and torch); the losses and accuracies to
  1e-6; ``torch_to_flax`` gives JAX's tree back exactly.
* The SAME max pool against flax's on an even and an odd side, exactly,
  and the naive ``max_pool2d(padding=1)`` shown to differ on the even one.
* The disagreement scores and their helpers: equal to JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import (assert_grads_close, load_flax, max_abs,
                             net_parity, rel_l2, t32)
from ode_rl_torch.convert import torch_to_flax
from ode_rl_torch.data.mmnist import (_trajectories, generate_moving_mnist,
                                      generate_moving_mnist_labeled,
                                      render_moving_mnist)
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.eval_models.mmnist_judge import MMNISTJudge, quadrant_labels
from ode_rl_torch.nn.impala import ImpalaCNN, max_pool_same
from ode_rl_torch.sprite import disagreement as port_dis
from ode_rl_torch.sprite.classifier import SpriteJudge

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
GEN = lambda: torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def bank():
    return get_sprite_bank()[:16]


def _jax_draws(key, bd: int, n_bank: int):
    """x0, y0, theta and the sprite index of each of JAX's ``bd`` digits,
    from its key as ``_generate`` splits it."""
    keys = jax.random.split(key, bd * 2).reshape(bd, 2)
    xs, ys, th, idx = [], [], [], []
    for k in range(bd):
        k1, k2, k3 = jax.random.split(keys[k, 0], 3)
        xs.append(jax.random.uniform(k1))
        ys.append(jax.random.uniform(k2))
        th.append(jax.random.uniform(k3) * 2.0 * jnp.pi)
        idx.append(jax.random.randint(keys[k, 1], (), 0, n_bank))
    as_t = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    return as_t(xs), as_t(ys), as_t(th), np.asarray(idx)


@pytest.mark.parametrize("batch,n_frames,digits", [(6, 20, 1), (3, 9, 2)])
def test_labelled_generator_matches_jax(bank, batch, n_frames, digits):
    from ode_rl_tpu.data.mmnist import generate_moving_mnist_labeled as jgen
    from ode_rl_tpu.eval_models.mmnist_judge import quadrant_labels as jquad

    key = jax.random.key(batch)
    video, idx, pos = jgen(key, jnp.asarray(bank), batch=batch,
                           n_frames=n_frames, num_digits=digits)
    x0, y0, theta, j_idx = _jax_draws(key, batch * digits, len(bank))
    assert np.array_equal(j_idx.reshape(batch, digits), np.asarray(idx))
    ours_pos = _trajectories(x0, y0, theta, n_frames)
    assert np.array_equal(ours_pos.numpy().reshape(np.asarray(pos).shape),
                          np.asarray(pos))
    assert ours_pos.dtype == torch.int32
    t_bank = torch.from_numpy(bank).float()
    ours_video = render_moving_mnist(t_bank, torch.from_numpy(
        np.array(idx)), torch.from_numpy(np.array(pos)))
    # The pixels are equal; the floats within one ulp of 0.5, since XLA
    # takes /255 as a multiply by the reciprocal.
    pixels = lambda v: np.rint((np.asarray(v) + 0.5) * 255.0)
    assert np.array_equal(pixels(ours_video), pixels(video))
    assert max_abs(ours_video, video) <= 2.0 ** -24
    for a, b in zip(quadrant_labels(torch.from_numpy(np.asarray(pos))),
                    jquad(pos)):
        assert np.array_equal(a.numpy(), np.asarray(b))

    # The port's labelled batch: its unlabelled batch from the same draws.
    v, i, p = generate_moving_mnist_labeled(
        torch.Generator().manual_seed(3), t_bank, batch, n_frames, digits)
    assert torch.equal(v, generate_moving_mnist(
        torch.Generator().manual_seed(3), t_bank, batch, n_frames, digits))
    assert tuple(i.shape) == (batch, digits)
    assert tuple(p.shape) == (batch, digits, n_frames, 2)
    assert torch.equal(v, render_moving_mnist(t_bank, i, p))


def test_quadrant_labels_at_the_borders():
    """Centres at 31 and 32 on either axis, at the first and last frame."""
    from ode_rl_tpu.eval_models.mmnist_judge import quadrant_labels as jquad

    pos = np.array([[[[17, 18], [36, 0]]],
                    [[[18, 18], [0, 0]]]], np.int32)      # (2, 1, 2, 2)
    ours = quadrant_labels(torch.from_numpy(pos))
    for a, b in zip(ours, jquad(jnp.asarray(pos))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert ours[0].tolist() == [1, 3] and ours[1].tolist() == [2, 0]


def _judge_batch(seed: int = 0, b: int = 3, t: int = 4):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, t, 64, 64, 1).astype(np.float32),
            rng.randint(0, 16, b), rng.randint(0, 4, b),
            rng.randint(0, 4, b))


def test_mmnist_judge_forward_and_gradients_match_jax():
    from ode_rl_tpu.eval_models.mmnist_judge import MMNISTJudge as JJudge

    video = jnp.asarray(_judge_batch()[0])
    jmod = JJudge()
    variables = jmod.init(jax.random.key(0), video)
    port = MMNISTJudge(16, generator=GEN())
    load_flax(port, variables["params"])
    ref = jmod.apply(variables, video)
    rng = np.random.RandomState(7)
    w = {k: rng.randn(*ref[k].shape).astype(np.float32) for k in sorted(ref)}

    def loss(params):
        out = jmod.apply({"params": params}, video)
        return sum(jnp.sum(out[k] * w[k]) for k in w)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    ours = port(t32(video))
    for k in w:
        assert rel_l2(ours[k], ref[k]) <= OUT_TOL, k
    sum(torch.sum(ours[k] * t32(w[k])) for k in w).backward()
    assert_grads_close(port, grads, GRAD_TOL)


def test_mmnist_judge_flattens_nhwc():
    """``fc_m`` reads the frame's map in flax's NHWC order: the same
    weights with the map flattened NCHW give other motion logits."""
    from ode_rl_tpu.eval_models.mmnist_judge import MMNISTJudge as JJudge

    video, s, q0, q1 = _judge_batch(1)
    jmod = JJudge()
    variables = jmod.init(jax.random.key(2), jnp.asarray(video))
    port = MMNISTJudge(16, generator=GEN())
    load_flax(port, variables["params"])
    ref = jmod.apply(variables, jnp.asarray(video))
    with torch.no_grad():
        ours = port(t32(video))
        for k in ("sprite", "q0", "q1"):
            assert rel_l2(ours[k], ref[k]) <= OUT_TOL, k
        h = t32(video)[:, 0]
        for conv in (port.c0, port.c1, port.c2):
            h = torch.relu(conv(h))
        nchw = port.head_q0(torch.relu(port.fc_m(
            h.permute(0, 3, 1, 2).reshape(3, -1))))
    assert rel_l2(nchw, ref["q0"]) > 0.1

    (j_loss, j_m) = jmod.apply(variables, jnp.asarray(video), s, q0, q1,
                               method=jmod.loss)
    loss, m = port.loss(t32(video), *(torch.from_numpy(a) for a in
                                      (s, q0, q1)))
    assert abs(float(loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    for k in j_m:
        assert abs(float(m[k]) - float(j_m[k])) <= 1e-6, k
    back = torch_to_flax(port.state_dict(), module=port)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["params"]):
        node = back
        for p in path:
            node = node[p.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf))


def test_sprite_judge_matches_jax():
    from ode_rl_tpu.sprite.classifier import SpriteJudge as JJudge

    rng = np.random.RandomState(4)
    z, f = (rng.randn(3, 5, 8).astype(np.float32),
            rng.randn(3, 12).astype(np.float32))
    port = SpriteJudge(8, 12, hidden=16, generator=GEN())
    net_parity(JJudge(hidden=16), port, [z, f], out_tol=OUT_TOL,
               grad_tol=GRAD_TOL)
    a, c = rng.randint(0, 4, 3), rng.randint(0, 6, 3)
    jmod = JJudge(hidden=16)
    variables = jmod.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(f))
    load_flax(port, variables["params"])
    j_loss, j_m = jmod.apply(variables, jnp.asarray(z), jnp.asarray(f), a,
                             c, method=jmod.loss)
    loss, m = port.loss(t32(z), t32(f), torch.from_numpy(a),
                        torch.from_numpy(c))
    assert abs(float(loss) / float(j_loss) - 1.0) <= 1e-6
    for k in j_m:
        assert abs(float(m[k]) - float(j_m[k])) <= 1e-6, k
    assert {"z_lstm.cell.ii.kernel", "z_lstm.cell.hg.bias",
            "attr_head.kernel"} <= set(port.state_dict())
    back = torch_to_flax(port.state_dict(), module=port)
    assert back["z_lstm"]["cell"]["hf"]["kernel"].shape == (16, 16)


@pytest.mark.parametrize("hw,out_features", [
    ((12, 12), None), ((9, 13), None), ((7, 10), 5), ((12, 12), 3)])
def test_impala_matches_jax(hw, out_features):
    from ode_rl_tpu.nn.impala import ImpalaCNN as JImpala

    depths = (4, 8)
    x = np.random.RandomState(5).randn(2, *hw, 3).astype(np.float32)
    port = ImpalaCNN(3, depths, out_features, in_hw=hw, generator=GEN())
    tol = 1e-4 if out_features else OUT_TOL
    net_parity(JImpala(depths=depths, out_features=out_features), port, [x],
               out_tol=tol, grad_tol=GRAD_TOL)
    names = set(port.state_dict())
    assert {"block0_conv.weight", "block1_res1.c1.weight"} <= names
    assert ("fc.kernel" in names) == (out_features is not None)
    back = torch_to_flax(port.state_dict(), module=port)
    assert back["block1_res0"]["c0"]["kernel"].shape == (3, 3, 8, 8)


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 9)])
def test_same_max_pool_matches_flax(hw):
    import flax.linen as nn

    x = np.random.RandomState(6).randn(2, *hw, 3).astype(np.float32)
    ref = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    ours = max_pool_same(t32(x))
    assert ours.shape == ref.shape and max_abs(ours, ref) == 0.0
    naive = F.max_pool2d(t32(x).permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
    if hw[0] % 2 == 0:   # an even side: the naive pad shifts the windows
        assert naive.shape != ref.shape or max_abs(naive, ref) > 0.0


def test_disagreement_scores_equal_jax():
    from ode_rl_tpu.sprite import disagreement as jax_dis

    rng = np.random.RandomState(7)
    logits = rng.randn(2, 40, 4)
    p1, p2 = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gt = rng.randint(0, 4, 40)
    assert port_dis.disagreement_scores(p1, p2, gt) == \
        jax_dis.disagreement_scores(p1, p2, gt)
    for name in ("entropy_hy", "entropy_hyx", "inception_score"):
        assert getattr(port_dis, name)(p2) == getattr(jax_dis, name)(p2)
    assert port_dis.kl_divergence(p1, p2) == jax_dis.kl_divergence(p1, p2)
    assert np.array_equal(port_dis.balanced_subset_index(gt),
                          jax_dis.balanced_subset_index(gt))
