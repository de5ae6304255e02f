"""S3VAE in the port against the JAX package, and the helpers its other
test files share (tests/test_torch_port_s3vae_{spatial,train,nets}.py and
tests/test_torch_port_rims.py).

The whole model for each of its seven encoder variants ('default',
'default' with slot attention, 'default' with the RIM dynamic head here;
'cgru', 'cgru_sa' with slots, 'cgru_rim' and 'odecgru' in the spatial
file), built by both registries from one ``configs.yaml`` block,
narrowed (B=2, 3 -> 3 frames, 64x64 frames for 'default', whose encoder
needs them, and 32x32 for the spatial encoders; ``encoder_out_dims`` 16,
d_zf 16, d_zt 8, slot_size 16). The port is loaded with JAX's init
(params and batch_stats, ``convert.py``, ``strict=True``) and draws JAX's
noise: JAX's ``jax.random.normal`` and ``permutation`` are replaced
inside the test by a recorder that makes each of the model's draws from a
seeded numpy generator, and the port's ``Noise`` replays the recorded
draws in order, checking each one's kind and shape. Nothing in
``ode_rl_tpu/`` changes.

Tolerances, as tests/test_torch_port_recipe.py: prediction 1e-4 max abs,
loss and each of the eight metrics 1e-5 relative (relative to at least
1e-2: a KL term near 0 is a sum of O(1) terms that cancel), BatchNorm
buffers 1e-5 relative L2, every gradient leaf 1e-3 relative L2 plus
1e-5 of the whole gradient's norm (an allclose, so that a leaf whose
gradient is zero in exact arithmetic is held to rounding: the biases of
the convs before a training-mode BatchNorm, slot attention's q/k path
on a set of one element, an unused gate; and so that a small leaf whose
sum cancels is held in proportion to the gradient it belongs to: after
one Adam step of the 'default' model a BatchNorm bias of 0.15% of the
whole norm lies 1.5e-3 of its own norm from fp64 in the port's fp32).
The gradients are held to JAX's computed in fp64 (the same model cloned
with fp64 compute and parameters under ``jax.enable_x64``): JAX's own
fp32 gradients of the 'default' model lie up to 4.4e-3 from its fp64
ones (the encoder's BatchNorm leaves: the backward through a
training-mode BatchNorm over 6 frames), the port's up to 6.0e-4, and the
port's fp64 ones within 6.0e-7 of JAX's. Run as a script (``JAX_PLATFORMS=cpu
python tests/test_torch_port_s3vae.py``), this file prints those readings.

The RIM variants run with dropout (0.5 and 0.1 in JAX's modules), whose
masks cannot be shared: they are held in eval mode (the 3 + 3-frame
rollout, BatchNorm on its running statistics), and their gradients to
JAX's fp32 ones: their active blocks are a top-k of the null-key
attention, which fp64 may pick otherwise (then JAX's own fp32 and fp64
gradients differ by 0.25 on the attention leaves).

Also here: the pure loss terms against JAX (SCC on 2-D, 4-D and 5-D
inputs, DFP's BCE, the MI estimate).
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import max_abs, np32, rel_l2, t32
from ode_rl_torch.convert import flax_to_torch
from ode_rl_torch.core.config import load_config
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model

B, T_IN = 2, 3
OUT_TOL, LOSS_TOL, GRAD_TOL, BN_TOL = 1e-4, 1e-5, 1e-3, 1e-5
# A metric's error is taken relative to at least this: a KL term near 0
# is a sum of O(1) terms that cancel (1 + lv - exp(lv)), so its rounding
# is absolute.
METRIC_FLOOR = 1e-2
# A gradient leaf's error may be GRAD_TOL of its norm plus GRAD_ATOL of the
# whole gradient's norm.
GRAD_ATOL = 1e-5
NARROW = dict(batch_size=B, train_in_seq=T_IN, train_out_seq=T_IN,
              encoder_out_dims=16, d_zf=16, d_zt=8, slot_size=16)
METRICS = {"loss", "vae_loss", "recon_loss", "kl_zf", "kl_zt", "scc_loss",
           "dfp_loss", "mi_loss"}

# (id, block, train, the gradients' reference): the seven encoder variants.
VARIANTS = [
    ("default", "train_mmnist_recon_s3vae", True, "f64"),
    ("default_slots", "train_mmnist_extrap_s4vae", True, "f64"),
    ("default_rim", "train_mmnist_recon_rims4vae", False, "f32"),
    ("cgru", "train_mmnist_recon_cs3vae", True, "f64"),
    ("cgru_sa_slots", "train_mmnist_recon_cs4vae", True, "f64"),
    ("cgru_rim", "train_mmnist_recon_cgrurims3vae", False, "f32"),
    ("odecgru", "train_mmnist_s3vae_odecgru", True, "f64"),
]


class Recorder:
    """Stands in for ``jax.random.normal``/``permutation``: each draw from
    a seeded numpy generator, recorded in order."""

    def __init__(self, seed: int = 5):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    # The files whose draws are the model's noise. Others, such as the
    # RIMs' parameter initialisers, which flax's lifted scan evaluates
    # again inside ``apply``, draw from the real functions.
    MODEL_FILES = ("models/s3vae.py", "nn/slot_attention.py")

    def __init__(self, seed: int = 5):
        self.rng = np.random.RandomState(seed)
        self.draws = []
        self.real = {"normal": jax.random.normal,
                     "permutation": jax.random.permutation}

    def _ours(self) -> bool:
        caller = sys._getframe(2).f_code.co_filename
        return caller.endswith(self.MODEL_FILES)

    def normal(self, key, shape, dtype=jnp.float32):
        if not self._ours():
            return self.real["normal"](key, shape, dtype)
        a = self.rng.randn(*shape).astype(np.float32)
        self.draws.append(("normal", a))
        return jnp.asarray(a, dtype)

    def permutation(self, key, n):
        if not self._ours():
            return self.real["permutation"](key, n)
        a = self.rng.permutation(int(n))
        self.draws.append(("permutation", a))
        return jnp.asarray(a)

    def patch(self, monkeypatch):
        monkeypatch.setattr(jax.random, "normal", self.normal)
        monkeypatch.setattr(jax.random, "permutation", self.permutation)


class Replay(Noise):
    """The port's ``Noise`` handing out a recorder's draws in order."""

    def __init__(self, draws):
        super().__init__(None)
        self.draws = list(draws)

    def _next(self, kind, shape):
        got, a = self.draws.pop(0)
        assert got == kind and a.shape == tuple(shape), (got, a.shape,
                                                         kind, shape)
        return a

    def permutation(self, n, device):
        return torch.from_numpy(self._next("permutation", (n,))).long()

    def normal(self, shape, like):
        return t32(self._next("normal", shape)).to(like.dtype)

    def dropout(self, x, rate):
        raise AssertionError("dropout draws cannot be shared with JAX")


def size_for(cfg) -> int:
    return 64 if cfg.get("encoder", "default") == "default" else 32


def video(seed: int = 0, size: int = 64, t: int = 2 * T_IN):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, t, size, size, 1) - 0.5).astype(np.float32)


def configs(block: str, **overrides):
    from ode_rl_tpu.core.config import load_config as jax_load
    ov = {**NARROW, **overrides}
    return (jax_load(["defaults", block], overrides=ov),
            load_config(["defaults", block], overrides=ov))


def jax_init(jcfg, jb):
    from ode_rl_tpu.models.registry import build_model as jax_build
    model = jax_build(jcfg)
    rngs = {"params": jax.random.key(0), "sample": jax.random.key(1),
            "dropout": jax.random.key(2)}
    variables = jax.jit(lambda b: model.init(rngs, b, train=True,
                                             method=model.loss))(jb)
    return model, dict(variables)


def jax_loss_fn(model, train: bool):
    """Jitted (params, state, batch) -> ((loss, (metrics, prediction, new
    state)), grads) of JAX's loss; its noise from whatever ``jax.random``
    holds when it is traced (once)."""

    def loss_fn(p, state, jb):
        (loss, (metrics, pred)), new_state = model.apply(
            {"params": p, **state}, jb, train=train, method=model.loss,
            mutable=list(state), rngs={"sample": jax.random.key(3),
                                       "dropout": jax.random.key(4)})
        return loss, (metrics, pred, new_state)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_loss_and_grads(model, variables, jb, train: bool):
    """(loss, metrics, prediction, new batch_stats, grads) of one JAX
    loss."""
    state = {k: v for k, v in variables.items() if k != "params"}
    (loss, (metrics, pred, new_state)), grads = jax_loss_fn(model, train)(
        variables["params"], state, jb)
    return loss, metrics, pred, new_state, grads


class JaxGradsF64:
    """JAX's gradients of the same loss in fp64: the model cloned with
    fp64 compute and parameters under ``jax.enable_x64``, the same draws
    (a recorder of the same seed makes them in the same order when the
    function is traced, once)."""

    def __init__(self, model, train: bool, seed: int = 5):
        self.model = model.clone(dtype=jnp.float64, param_dtype=jnp.float64)
        self.train, self.seed, self.fn = train, seed, None

    def __call__(self, variables, jb) -> dict:
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: (jnp.asarray(np.asarray(a), jnp.float64)
                       if np.asarray(a).dtype == np.float32 else a), t)
        with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
            Recorder(self.seed).patch(mp)
            self.fn = self.fn or jax_loss_fn(self.model, self.train)
            v = f64(variables)
            state = {k: x for k, x in v.items() if k != "params"}
            _, grads = self.fn(v["params"], state, f64(jb))
            grads = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), grads)
        return flax_to_torch(grads)


def load_port(port, variables) -> None:
    tree = jax.tree_util.tree_map(np.asarray, variables)
    port.load_state_dict(flax_to_torch(tree["params"],
                                       tree.get("batch_stats")), strict=True)


def port_loss_and_grads(port, batch, noise, train: bool):
    port.train(train)
    port.zero_grad(set_to_none=True)
    loss, (metrics, pred) = port.loss(batch, noise)
    loss.backward()
    return metrics, pred.detach()


def port_f64(port):
    """A copy of ``port`` computing in fp64 (parameters, buffers and every
    module's compute dtype)."""
    port = copy.deepcopy(port).double()
    for module in port.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = torch.float64
    return port


def f64_batch(batch: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


def grads_of(port) -> dict:
    """Every parameter's gradient; an unused one (JAX: exactly zero) as
    zeros."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in port.named_parameters()}


def assert_buffers_close(port, batch_stats, tol=BN_TOL) -> None:
    ref = flax_to_torch({}, jax.tree_util.tree_map(np.asarray, batch_stats))
    ours = dict(port.named_buffers())
    assert set(ref) == set(ours)
    for name in ref:
        assert rel_l2(ours[name], ref[name]) <= tol, name


def assert_grads_match(port, refs, rtol=None, atol=None) -> dict:
    """Every leaf against JAX's gradient, as numpy's allclose: the error's
    L2 norm at most ``rtol`` (GRAD_TOL) of the leaf's norm plus ``atol``
    (GRAD_ATOL) of the whole gradient's norm. Returns each leaf's error
    over its bound."""
    rtol = GRAD_TOL if rtol is None else rtol
    atol = GRAD_ATOL if atol is None else atol
    ours = grads_of(port)
    assert set(refs) == set(ours)
    refs = {k: v.double() for k, v in refs.items()}
    total = float(torch.sqrt(sum(torch.sum(g ** 2) for g in refs.values())))
    ratios = {}
    for name, ref in refs.items():
        err = float(torch.linalg.vector_norm(ours[name].double() - ref))
        bound = rtol * float(torch.linalg.vector_norm(ref)) + atol * total
        ratios[name] = err / bound
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1.0, f"{worst}: {ratios[worst]:.3g} of its bound"
    return ratios


def model_parity(block, monkeypatch, train=True, grad_ref="f64", seed=0,
                 **overrides):
    """One loss and its gradients of ``block``'s S3VAE through both
    registries from JAX's init, the same noise on both sides: the
    prediction, the metrics and the BatchNorm buffers against JAX in
    fp32, the gradients against JAX in fp64 (``grad_ref`` "f64") or fp32
    ("f32"). Returns the port's model and JAX's updated batch_stats."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch

    jcfg, cfg = configs(block, **overrides)
    v = video(seed, size_for(cfg))
    jb = jax_batch(jnp.asarray(v), n_in=T_IN, with_flow_labels=True)
    model, variables = jax_init(jcfg, jb)
    rec = Recorder()
    rec.patch(monkeypatch)
    _, j_metrics, j_pred, j_state, j_grads = jax_loss_and_grads(
        model, variables, jb, train)
    monkeypatch.undo()
    grads = (JaxGradsF64(model, train)(variables, jb) if grad_ref == "f64"
             else flax_to_torch(jax.tree_util.tree_map(np.asarray, j_grads)))

    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    load_port(port, variables)
    batch = make_batch_dict(t32(v), T_IN, with_flow_labels=True)
    for k in ("in_flow_labels", "out_flow_labels"):
        assert np.array_equal(np32(batch[k]), np32(jb[k])), k
    replay = Replay(rec.draws)
    metrics, pred = port_loss_and_grads(port, batch, replay, train)
    assert not replay.draws, "draws left over"
    assert pred.shape == j_pred.shape
    assert max_abs(pred, j_pred) <= OUT_TOL
    assert set(metrics) == METRICS == set(j_metrics)
    for k in METRICS:
        ref = float(j_metrics[k])
        err = abs(float(metrics[k]) - ref) / max(abs(ref), METRIC_FLOOR)
        assert err <= LOSS_TOL, (k, float(metrics[k]), ref)
    assert_grads_match(port, grads)
    if train:
        assert_buffers_close(port, j_state["batch_stats"])
    return port, j_state


VECTOR = [v for v in VARIANTS if v[0].startswith("default")]


@pytest.mark.parametrize("name,block,train,grad_ref", VECTOR,
                         ids=[v[0] for v in VECTOR])
def test_s3vae_matches_jax(name, block, train, grad_ref, monkeypatch):
    port, _ = model_parity(block, monkeypatch, train=train,
                           grad_ref=grad_ref)
    names = {n for n, _ in port.named_parameters()}
    if name.startswith("default"):
        # The VALID transposed conv: flax's kernel flipped, (in, out, 4, 4).
        assert port.conv_decoder.deconv_in.weight.shape[1:] == (512, 4, 4)
        assert "static_rnn.gru.cell.in.kernel" in names
    if name == "odecgru":
        assert "dynamic_rnn.ode_func.mid_2.kernel" in names
        assert port.dynamic_rnn.ode_z0.head_1.weight.shape[0] == 2 * 8
    if name == "cgru_rim":
        assert port.static_rnn.cgru_rim.core.block_cgru.gates.groups == 4


# ---------------------------- the loss terms ------------------------------

@pytest.mark.parametrize("shape", [(4, 6), (4, 3, 5, 6), (4, 2, 3, 5, 6)])
def test_scc_triplet_matches_jax(shape):
    """The distance reduces one axis: -2 from rank 4 on, else -1; the
    1e-6 goes into the difference."""
    from ode_rl_tpu.models.s3vae import scc_triplet_loss as jax_scc
    from ode_rl_torch.models.s3vae import scc_triplet_loss

    rng = np.random.RandomState(2)
    a, p, n = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    for margin in (0.5, 3.0):
        ref = float(jax_scc(jnp.asarray(a), jnp.asarray(p), jnp.asarray(n),
                            margin))
        ours = float(scc_triplet_loss(t32(a), t32(p), t32(n), margin))
        assert abs(ours - ref) <= 1e-6 * max(abs(ref), 1.0)
    # Not a norm over the whole sample: summing another axis differs.
    if len(shape) >= 4:
        d = torch.sqrt(torch.sum((t32(a) - t32(p) + 1e-6) ** 2, dim=-1))
        assert d.shape != torch.Size(shape[:-2] + shape[-1:])


def test_dfp_and_mi_match_jax():
    from ode_rl_tpu.models.s3vae import dfp_bce_loss as jax_dfp
    from ode_rl_tpu.models.s3vae import mi_estimate as jax_mi
    from ode_rl_torch.models.s3vae import dfp_bce_loss, mi_estimate

    rng = np.random.RandomState(3)
    logits = 3 * rng.randn(2, 4, 9).astype(np.float32)
    labels = (rng.rand(2, 4, 9) > 0.5).astype(np.float32)
    assert abs(float(dfp_bce_loss(t32(logits), t32(labels)))
               / float(jax_dfp(logits, labels)) - 1) <= 1e-6
    for zshape in ((5,), (2, 2, 3)):
        mu_t, zt = (rng.randn(4, 3, *zshape).astype(np.float32)
                    for _ in range(2))
        std_t = (0.5 + rng.rand(4, 3, *zshape)).astype(np.float32)
        mu_f, zf = (rng.randn(3, *zshape).astype(np.float32)
                    for _ in range(2))
        std_f = (0.5 + rng.rand(3, *zshape)).astype(np.float32)
        args = (mu_t, std_t, zt, mu_f, std_f, zf)
        log_nm = float(np.log(np.float32(8000 * 3)))
        ref = float(jax_mi(*map(jnp.asarray, args), log_nm))
        ours = float(mi_estimate(*map(t32, args), log_nm))
        assert abs(ours - ref) <= 1e-5 * max(abs(ref), 1e-3)




def _precision_readings() -> None:
    """Prints how far each side's fp32 gradients lie from fp64, the
    readings behind the S3VAE tests' choice of reference: the 'default'
    model (B=2, 3 -> 3 frames) at JAX's init on the first batch, and on
    the second after one Adam step of the port (as the three-step test
    takes them), JAX's fp32 and the port's fp32 against JAX's fp64, and
    the port's fp64 against JAX's fp64 (worst leaf above 1e-6 of the
    whole norm, relative L2); then the 'cgru_sa' frame decoder alone in
    eval mode, the port's fp32 against its fp64."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_torch.train.step import create_train_state, make_train_step

    jcfg, cfg = configs("train_mmnist_recon_s3vae")
    videos = [video(0, 64), video(1, 64)]
    model, variables = jax_init(jcfg, jax_batch(
        jnp.asarray(videos[0]), n_in=T_IN, with_flow_labels=True))
    state = create_train_state(cfg, torch.device("cpu"))
    load_port(state.model, variables)
    for label, v in (("at init", videos[0]),
                     ("after one Adam step", videos[1])):
        jb = jax_batch(jnp.asarray(v), n_in=T_IN, with_flow_labels=True)
        batch = make_batch_dict(t32(v), T_IN, with_flow_labels=True)
        sd = state.model.state_dict()
        params = jax.tree_util.tree_map_with_path(
            lambda kp, ref: _from_port(sd, tuple(k.key for k in kp), ref),
            variables["params"])
        stats = jax.tree_util.tree_map_with_path(
            lambda kp, ref: _from_port(sd, tuple(k.key for k in kp), ref),
            variables["batch_stats"])
        synced = {"params": params, "batch_stats": stats}
        rec = Recorder()
        with pytest.MonkeyPatch.context() as mp:
            rec.patch(mp)
            j32 = jax_loss_and_grads(model, synced, jb, True)[4]
        j32 = {k: v.double() for k, v in flax_to_torch(
            jax.tree_util.tree_map(np.asarray, j32)).items()}
        j64 = JaxGradsF64(model, True)(synced, jb)
        p32 = port_loss_grads(state.model, batch, rec.draws)
        p64 = port_loss_grads(port_f64(state.model), f64_batch(batch),
                              rec.draws)
        total = float(torch.sqrt(sum(torch.sum(g ** 2)
                                     for g in j64.values())))
        live = [n for n in j64 if float(j64[n].norm()) > 1e-6 * total]
        for name, grads in (("JAX fp32", j32), ("port fp32", p32),
                            ("port fp64", p64)):
            errs = {n: rel_l2(grads[n], j64[n]) for n in live}
            worst = max(errs, key=errs.get)
            print(f"{label}: {name} against JAX fp64, worst leaf {worst} "
                  f"{errs[worst]:.3e}")
        make_train_step()(state, batch, Replay(rec.draws))

    # As tests/test_torch_port_s3vae_nets.py holds the decoder: flax's
    # init, the encoder's output in eval mode, weights from seed 7.
    from ode_rl_tpu.nn.s3vae_nets import FrameDecoder as JaxDecoder
    from ode_rl_tpu.nn.s3vae_nets import FrameEncoder as JaxEncoder
    from ode_rl_torch.nn.s3vae_nets import FrameDecoder, FrameEncoder

    gen = torch.Generator().manual_seed(0)
    x = np.random.RandomState(3).rand(3, 32, 32, 1).astype(np.float32)
    enc = FrameEncoder(1, "cgru_sa", 8, generator=gen)
    load_port(enc, JaxEncoder(encoder_type="cgru_sa", out_dims=8).init(
        jax.random.key(0), jnp.asarray(x), train=False))
    with torch.no_grad():
        z = enc(t32(x), False)
    dec = FrameDecoder(8, "cgru_sa", 1, generator=gen)
    load_port(dec, JaxDecoder(encoder_type="cgru_sa", final_dim=1).init(
        jax.random.key(0), jnp.asarray(np32(z)), train=False))
    w = torch.from_numpy(np.random.RandomState(7).randn(3, 32, 32, 1))
    grads = []
    for module, inp in ((dec, z), (port_f64(dec), z.double())):
        torch.sum(module(inp, False) * w.to(inp.dtype)).backward()
        grads.append({n: p.grad.double()
                      for n, p in module.named_parameters()})
    errs = {n: rel_l2(grads[0][n], grads[1][n]) for n in grads[1]}
    worst = max(errs, key=errs.get)
    print(f"'cgru_sa' frame decoder, eval: port fp32 against its fp64, "
          f"worst leaf {worst} {errs[worst]:.3e}")


def _from_port(sd, path, ref):
    """The port's value of a flax leaf (the inverse of ``convert.py``)."""
    from ode_rl_torch.convert import _is_field_conv, _is_transposed_conv

    layer, name = path[-2], path[-1]
    if name != "kernel" or ref.ndim != 4 or _is_field_conv(layer):
        return jnp.asarray(np32(sd[".".join(path)]).copy())
    w = np32(sd[".".join(path[:-1] + ("weight",))])
    w = (np.flip(w.transpose(2, 3, 0, 1), (0, 1))
         if _is_transposed_conv(layer) else w.transpose(2, 3, 1, 0))
    return jnp.asarray(np.ascontiguousarray(w))


def port_loss_grads(port, batch, draws) -> dict:
    port_loss_and_grads(port, batch, Replay(draws), True)
    return {n: g.double() for n, g in grads_of(port).items()}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_port_s3vae.py
    jax.config.update("jax_platforms", "cpu")
    _precision_readings()
