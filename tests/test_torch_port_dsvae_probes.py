"""The DS-VAE's six probe forwards in the port against the JAX package.

``DisentangledVAE`` narrowed as in tests/test_torch_port_dsvae.py (f_dim
16, z_dim 8, g_dim 16, rnn_size 16; the DCGAN nets at JAX's nf 64; B=4,
8 frames of 64x64x3 in [0, 1]), loaded with JAX's init (params and
BatchNorm statistics, ``convert.py``), in eval mode, each probe with
JAX's draws replayed in order through the port's ``Noise`` (the
recorder of tests/test_torch_port_s3vae.py): the posterior's f and z,
then the free prior's per-step draws or the resampled content. Each
output to 1e-5 max abs in fp32 (forward only: no gradient is ill-
conditioned here); every draw consumed. One probe in training mode too
(BatchNorm on the batch's moments), whose moved statistics must equal
JAX's to 1e-5 relative L2. ``forward_exchange`` on an odd batch fails in
the reshape on both sides.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, rel_l2, t32
from test_torch_port_s2vae import SlotRecorder, configs, load_port
from test_torch_port_s3vae import Replay
from ode_rl_torch.models.registry import build_model

NARROW = {"f_dim": 16, "z_dim": 8, "g_dim": 16, "rnn_size": 16}
B, T = 4, 8
PROBES = ("forward_exchange", "forward_fixed_content_for_classification",
          "forward_fixed_action_for_classification", "forward_fixed_motion",
          "forward_fixed_content", "forward_generating")


@pytest.fixture(scope="module")
def models():
    from ode_rl_tpu.models.registry import build_model as jax_build

    jcfg, cfg = configs("train_sprite_dsvae", T, batch_size=B,
                        train_out_seq=0, **NARROW)
    x = np.random.RandomState(2).rand(B, T, 64, 64, 3).astype(np.float32)
    model = jax_build(jcfg)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1)}
    variables = jax.jit(lambda v: model.init(rngs, v, train=True))(
        jnp.asarray(x))
    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    load_port(port, variables)
    return model, variables, port, x


def _jax_probe(model, variables, probe, x, train=False):
    rec = SlotRecorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        out, state = jax.jit(lambda v: model.apply(
            variables, v, train=train, method=getattr(model, probe),
            rngs={"sample": jax.random.key(3)},
            mutable=["batch_stats"]))(jnp.asarray(x))
    return out, state, rec.draws


@pytest.mark.parametrize("probe", PROBES)
def test_probe_matches_jax(models, probe):
    model, variables, port, x = models
    ref, _, draws = _jax_probe(model, variables, probe, x)
    replay = Replay(draws)
    with torch.no_grad():
        ours = getattr(port, probe)(t32(x), replay)
    assert not replay.draws, "draws left over"
    ref = ref if isinstance(ref, tuple) else (ref,)
    ours = ours if isinstance(ours, tuple) else (ours,)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == b.shape == (B, T, 64, 64, 3)
        assert max_abs(a, b) <= 1e-5


def test_probe_in_training_mode_moves_batch_stats_as_jax(models):
    model, variables, port, x = models
    ref, state, draws = _jax_probe(model, variables, "forward_generating",
                                   x, train=True)
    port = copy.deepcopy(port)
    with torch.no_grad():
        ours = port.forward_generating(t32(x), Replay(draws), train=True)
    assert max_abs(ours, ref) <= 1e-5
    buffers = dict(port.named_buffers())
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            state["batch_stats"]):
        name = ".".join(p.key for p in path)
        assert rel_l2(buffers[name], leaf) <= 1e-5, name


def test_exchange_swaps_pairs_and_refuses_an_odd_batch(models):
    model, variables, port, x = models
    _, _, draws = _jax_probe(model, variables, "forward_exchange", x)
    with torch.no_grad():
        ours = port.forward_exchange(t32(x), Replay(draws))
        _, _, f_post, _, _, z_post = port.encode_and_sample_post(
            t32(x), False, Replay(draws))
        by_hand = port._decode(z_post, f_post[[1, 0, 3, 2]], False)
    assert torch.equal(ours, by_hand)
    with pytest.raises(TypeError):
        _jax_probe(model, variables, "forward_exchange", x[:3])
    with pytest.raises(RuntimeError, match="invalid for input of size 3"):
        with torch.no_grad():
            port.forward_exchange(t32(x[:3]),
                                  torch.Generator().manual_seed(0))
