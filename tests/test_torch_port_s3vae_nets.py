"""S3VAE's modules in the port against their flax counterparts, one by one:
BatchNorm and LayerNorm (nn/norm.py), flax's GRU cell and the hoisted GRU
(nn/dense.py), the frame encoders and decoders of every type in training
and eval mode (with the BatchNorm buffers), the vector and spatial heads,
DFP, slot attention and its autoencoder (slot noise replayed from JAX's
draws, tests/test_torch_port_s3vae.py), and the registry's build of every
S3VAE train block against JAX's ``init`` shapes.

Each module: the same seeded numpy inputs and JAX's init converted
(``convert.py``, ``strict=True``); in fp32 the outputs to 1e-5 max abs
(1e-4 for the frame stacks and the spatial heads, whose outputs are sums
of thousands of products) and the BatchNorm buffers to 1e-5 relative L2;
then every gradient leaf of sum(outputs * w) for random w in fp64 on both
sides (flax's module cloned with fp64 compute and parameters), to 1e-6
relative L2 plus 1e-9 of the whole gradient's norm (1e-5 where the
ConvGRU's gate GroupNorm takes its moments in fp32 on both sides). In
fp32 these gradients are ill-conditioned: the port's fp32 gradients of
the 'cgru_sa' frame decoder in eval mode lie up to 8.4e-3 from its fp64
ones (printed by ``python tests/test_torch_port_s3vae.py``); the whole
models hold their fp32 gradients (tests/test_torch_port_s3vae.py).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, rel_l2, t32
from test_torch_port_s3vae import (B, T_IN, Recorder, Replay,
                                   assert_buffers_close, assert_grads_match,
                                   load_port, port_f64)
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import load_config
from ode_rl_torch.models.registry import build_model
from ode_rl_torch.nn.dense import GRU, GRUCell
from ode_rl_torch.nn.norm import BatchNorm, LayerNorm
from ode_rl_torch.nn.s3vae_nets import (DFP, ConvGRUEncoderS3, FrameDecoder,
                                        FrameEncoder, GRUEncoder)
from ode_rl_torch.nn.slot_attention import (SlotAttentionAutoEncoder,
                                            spatial_broadcast)

RNGS = {"params": jax.random.key(0), "sample": jax.random.key(1),
        "dropout": jax.random.key(2)}


def _gen():
    return torch.Generator().manual_seed(0)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def module_parity(flax_mod, port_mod, inputs, port_call, *, call_kw=None,
                  out_tol=1e-5, rtol=1e-6):
    """Outputs and (where the module has them) the BatchNorm buffers after
    the call, flax against the port in fp32; then the gradients of
    sum(outputs * w) in fp64 on both sides (flax's module cloned with fp64
    compute and parameters, the port's copied to fp64), each leaf to
    ``rtol`` of its norm plus 1e-9 of the whole norm. The module's draws
    are recorded on JAX's side and replayed on the port's."""
    call_kw = call_kw or {}
    j_in = [jnp.asarray(a) for a in inputs]
    variables = dict(flax_mod.init(RNGS, *j_in, **call_kw))
    load_port(port_mod, variables)
    state = {k: v for k, v in variables.items() if k != "params"}

    def as_list(o):
        # Nested outputs (a RIM's list of final states) flattened in order.
        return jax.tree_util.tree_leaves(o)

    def apply(module, p, st, xs):
        out = module.apply({"params": p, **st}, *xs, **call_kw,
                           mutable=list(st) or False,
                           rngs={"sample": jax.random.key(3)})
        out, new_state = out if st else (out, {})
        return as_list(out), new_state

    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        j_outs, j_state = jax.jit(lambda p: apply(
            flax_mod, p, state, j_in))(variables["params"])
    t_outs = as_list(port_call(port_mod, *[t32(a) for a in inputs],
                               noise=Replay(rec.draws)))
    assert [tuple(o.shape) for o in t_outs] == [o.shape for o in j_outs]
    for a, b in zip(t_outs, j_outs):
        assert max_abs(a, b) <= out_tol
    if "batch_stats" in j_state:
        assert_buffers_close(port_mod, j_state["batch_stats"])

    rng = np.random.RandomState(7)
    weights = [rng.randn(*o.shape) for o in j_outs]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        Recorder().patch(mp)
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        flax64 = flax_mod.clone(dtype=jnp.float64, param_dtype=jnp.float64)
        xs64 = [cast(a) for a in j_in]
        loss64 = lambda p: sum(jnp.sum(o * w) for o, w in zip(
            apply(flax64, p, cast(state), xs64)[0], weights))
        j_grads = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jax.jit(jax.grad(loss64))(cast(variables["params"])))
    port64 = port_f64(port_mod)
    load_port(port64, variables)
    port64.double()
    outs64 = as_list(port_call(port64, *[t32(a).double() for a in inputs],
                               noise=Replay(rec.draws)))
    sum(torch.sum(o * torch.from_numpy(w))
        for o, w in zip(outs64, weights)).backward()
    assert_grads_match(port64, flax_to_torch(j_grads), rtol=rtol, atol=1e-9)
    return t_outs


# ------------------------------- the norms --------------------------------

@pytest.mark.parametrize("shape", [(4, 2, 2, 3), (6, 5)])
def test_batchnorm_matches_flax_and_not_torch(shape):
    """Training mode: the output, its gradients and the running statistics
    after two updates (biased variance, ``momentum`` 0.9 keeping 90% of
    the running value); then eval mode on them."""
    x1, x2 = 1.0 + 2.0 * _rand(*shape, seed=1), _rand(*shape, seed=2)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = flax_bn.init(RNGS, jnp.asarray(x1))
    port = BatchNorm(shape[-1])
    load_port(port, variables)
    stats = variables["batch_stats"]
    for x in (x1, x2):
        y, new = flax_bn.apply({**variables, "batch_stats": stats},
                               jnp.asarray(x), mutable=["batch_stats"])
        stats = new["batch_stats"]
        assert max_abs(port(t32(x), train=True), y) <= 1e-5
    assert_buffers_close(port, stats)
    # torch's BatchNorm keeps the unbiased variance: after the same two
    # updates its running variance is another number.
    if len(shape) == 4:
        ref = torch.nn.BatchNorm2d(shape[-1], eps=1e-5, momentum=0.1)
        for x in (x1, x2):
            ref(t32(x).permute(0, 3, 1, 2))
        assert rel_l2(ref.running_var, np32(stats["var"])) > 1e-3
    y = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                      epsilon=1e-5).apply({**variables, "batch_stats": stats},
                                          jnp.asarray(x1))
    assert max_abs(port(t32(x1), train=False), y) <= 1e-5
    module_parity(flax_bn, BatchNorm(shape[-1]), [x1],
                  lambda m, x, noise: m(x, train=True))


def test_layernorm_matches_flax():
    x = 3.0 + _rand(2, 5, 7)
    out = module_parity(fnn.LayerNorm(), LayerNorm(7), [x],
                        lambda m, x, noise: m(x))[0]
    # flax's eps is 1e-6, torch's default 1e-5.
    assert max_abs(out, torch.nn.functional.layer_norm(
        t32(x), (7,), eps=1e-5)) > 0


# -------------------------------- the GRU ---------------------------------

def test_gru_cell_matches_flax():
    """flax's GRUCell: input biases on r, z and n, a hidden bias on n
    only; none on the hidden r and z, which torch's GRUCell would train."""
    cell = GRUCell(5, 6, generator=_gen())
    names = {n for n, _ in cell.named_parameters()}
    assert "hr.bias" not in names and "hz.bias" not in names
    assert "hn.bias" in names and len(names) == 10
    h, x = _rand(B, 6, seed=1), _rand(B, 5, seed=2)
    module_parity(fnn.GRUCell(features=6), cell, [h, x],
                  lambda m, h, x, noise: (m(h, x),) * 2)


def test_gru_matches_jax():
    """The hoisted GRU (JAX's ``_GRU``) over a sequence, from zeros and
    from a given state."""
    from ode_rl_tpu.nn.s3vae_nets import _GRU

    xs, h0 = _rand(B, 4, 5, seed=1), _rand(B, 6, seed=2)
    module_parity(_GRU(hidden=6), GRU(5, 6, generator=_gen()), [xs],
                  lambda m, xs, noise: m(xs))
    module_parity(_GRU(hidden=6), GRU(5, 6, generator=_gen()), [xs, h0],
                  lambda m, xs, h0, noise: m(xs, h0))


# ---------------------------- the frame stacks ----------------------------

@pytest.mark.parametrize("encoder,size", [("default", 64), ("cgru", 32),
                                          ("odecgru", 32), ("cgru_rim", 32),
                                          ("cgru_sa", 32)])
@pytest.mark.parametrize("train", [True, False])
def test_frame_stacks_match_jax(encoder, size, train):
    from ode_rl_tpu.nn.s3vae_nets import FrameDecoder as JaxDecoder
    from ode_rl_tpu.nn.s3vae_nets import FrameEncoder as JaxEncoder

    x = np.random.RandomState(3).rand(3, size, size, 1).astype(np.float32)
    enc = module_parity(
        JaxEncoder(encoder_type=encoder, out_dims=8),
        FrameEncoder(1, encoder, 8, generator=_gen()), [x],
        lambda m, x, noise: m(x, train), call_kw={"train": train},
        out_tol=1e-4)[0]
    z = np32(enc)
    if encoder == "default":
        assert enc.shape == (3, 1, 1, 8)
    dec = module_parity(
        JaxDecoder(encoder_type=encoder, final_dim=1),
        FrameDecoder(8, encoder, 1, generator=_gen()), [z],
        lambda m, z, noise: m(z, train), call_kw={"train": train},
        out_tol=1e-4)[0]
    assert dec.shape == (3, size, size, 1)


# ------------------------------- the heads --------------------------------

@pytest.mark.parametrize("head", ["static", "dynamic", "prior"])
def test_gru_encoder_matches_jax(head):
    from ode_rl_tpu.nn.s3vae_nets import GRUEncoder as JaxHead

    xs = _rand(B, 4, 6, seed=4)
    kw = {"out_seq": 5} if head == "dynamic" else {}
    module_parity(JaxHead(hidden=16, z_size=4, head_type=head),
                  GRUEncoder(6, 16, 4, head, generator=_gen()), [xs],
                  lambda m, xs, noise: m(xs, noise=noise, **kw), call_kw=kw)


@pytest.mark.parametrize("mode,head", [("cgru", "static"), ("cgru", "dynamic"),
                                       ("cgru", "prior"),
                                       ("odecgru", "dynamic")])
def test_conv_heads_match_jax(mode, head):
    """The spatial heads with their ConvGRU (kernels K3/K4's plain
    versions here) and the 'odecgru' z0 and dopri5 rollout (K1/K2's)."""
    from ode_rl_tpu.nn.s3vae_nets import ConvGRUEncoderS3 as JaxHead

    xs = np.tanh(_rand(B, 3, 4, 4, 8, seed=5))
    kw = {"out_seq": 4} if head == "dynamic" else {}
    module_parity(JaxHead(out_ch=6, head_type=head, mode=mode,
                          ode_n_units=8),
                  ConvGRUEncoderS3(8, 6, head, mode, ode_n_units=8,
                                   generator=_gen()), [xs],
                  lambda m, xs, noise: m(xs, noise=noise, **kw), call_kw=kw,
                  out_tol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("spatial", [False, True])
def test_dfp_matches_jax(spatial):
    from ode_rl_tpu.nn.s3vae_nets import DFP as JaxDFP

    zt = (_rand(B, 4, 4, 4, 6, seed=6) if spatial
          else _rand(B, 4, 12, seed=6))
    port = DFP(zt.shape[-1], 6, 9, spatial=spatial, generator=_gen())
    out = module_parity(JaxDFP(z_size=6, grids=9, spatial=spatial), port,
                        [zt], lambda m, zt, noise: m(zt))[0]
    assert out.shape == (B, 3, 9)


# ---------------------------- slot attention ------------------------------

@pytest.mark.parametrize("conv_input", [False, True])
def test_slot_attention_matches_jax(conv_input):
    """The autoencoder on a vector (a set of one) and on a map (a set of
    H*W), its slot-init noise replayed from JAX's draw; slots_mu and
    slots_log_sigma are parameters."""
    from ode_rl_tpu.nn.slot_attention import (
        SlotAttentionAutoEncoder as JaxSA)

    x = _rand(B, 3, 3, 10, seed=7) if conv_input else _rand(B, 10, seed=7)
    port = SlotAttentionAutoEncoder(10, num_slots=3, slot_size=8,
                                    conv_input=conv_input, generator=_gen())
    out = module_parity(JaxSA(d_features=10, num_slots=3, slot_size=8,
                              conv_input=conv_input), port, [x],
                        lambda m, x, noise: m(x, noise))[0]
    assert out.shape == (B, 3, 8)
    # Parameters: their gradients are among those held to flax's above.
    names = {n for n, _ in port.named_parameters()}
    assert {"slot_attention.slots_mu",
            "slot_attention.slots_log_sigma"} <= names
    assert port.slot_attention.slots_mu.shape == (1, 1, 8)


def test_spatial_broadcast_matches_jax():
    from ode_rl_tpu.nn.slot_attention import spatial_broadcast as jax_sb

    slots = _rand(B, 3, 4, seed=8)
    ours = spatial_broadcast(t32(slots), (2, 5))
    assert ours.shape == (B * 3, 2, 5, 4)
    assert max_abs(ours, jax_sb(jnp.asarray(slots), (2, 5))) == 0.0


# ----------------------------- the registry -------------------------------

TRAIN_BLOCKS = [
    "train_mmnist_recon_s3vae", "train_mmnist_extrap_s3vae",
    "train_mmnist_recon_cs3vae", "train_mmnist_extrap_cs3vae",
    "train_mmnist_s3vae_odecgru", "train_mmnist_s3vaeode",
    "train_mmnist_recon_s4vae", "train_mmnist_extrap_s4vae",
    "train_mmnist_recon_cs4vae", "train_mmnist_extrap_cs4vae",
    "train_mmnist_recon_rims4vae", "train_mmnist_recon_cgrurims3vae",
    "train_mmnist_recon_rimconvs4vae"]


@pytest.mark.parametrize("block", TRAIN_BLOCKS)
def test_registry_builds_jax_shapes(block):
    """Every train block at its own widths: the port's parameter and
    buffer shapes equal JAX's ``init`` shapes (``jax.eval_shape``: no
    compute). As JAX builds it: ``n_hid`` 512 unless ``rim``; the vector
    RIM's own 3 blocks whatever ``num_blocks`` says; ``rim`` doing nothing
    for 'cgru_sa'; slots only for 'default' and 'cgru_sa'."""
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build

    ov = {"batch_size": B, "train_in_seq": T_IN, "train_out_seq": T_IN}
    jcfg = jax_load(["defaults", block], overrides=ov)
    cfg = load_config(["defaults", block], overrides=ov)
    model = jax_build(jcfg)
    jb = jax_batch(jnp.zeros((B, 2 * T_IN, 64, 64, 1)), n_in=T_IN,
                   with_flow_labels=True)
    shapes = jax.eval_shape(lambda b: model.init(
        RNGS, b, train=True, method=model.loss), jb)
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)
    ref = flax_to_torch(zeros(shapes["params"]),
                        zeros(shapes.get("batch_stats", {})))
    port = build_model(cfg, torch.device("cpu"), _gen())
    ours = port.state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
    if cfg.get("rim", False) and cfg.encoder == "default":
        assert port.dynamic_rnn.rim.core_0.num_blocks_out == 3
        assert port.dynamic_rnn.gru.hidden == 300
    elif cfg.encoder == "default":
        assert port.static_rnn.gru.hidden == 512
    if block == "train_mmnist_recon_rimconvs4vae":
        assert port.use_slots and hasattr(port.dynamic_rnn, "cgru_cell")
    if cfg.encoder == "cgru_rim":
        assert port.dynamic_rnn.cgru_rim.core.k == 4
