"""The port's corpus writer, parity eval, ``checked_odeint`` and profiler
against the JAX package.

* The native generator (data/native_gen.py) and
  ``python -m ode_rl_torch.make_frozen_mmnist`` at ``--videos 256
  --frames 200 --train_split 0.75`` (192 train and 64 test videos of 3
  digits, the corpus the card writes too): each shard's sha256 equals the
  constants ``chip_smoke.py`` holds the card to, and every byte equals an
  independent reference of ``native/mmnist_gen.cc``'s physics (SplitMix64
  in Python integers, every float step in numpy fp32, libm's
  ``sinf``/``cosf`` through ctypes, no FMA) rendered by the port's
  renderer. JAX's ``generate_batch`` (built with ``-march=native``)
  contracts the trajectory step into an FMA: its bytes equal the same
  reference with the step taken by libm's ``fmaf``, and equal the
  port's on every video where the two references agree; here they differ
  in 1 of the 256 videos (train shard video 46).
* The bridge raises, with the compiler's message, where the source is
  missing, does not compile or the compiler does not run; it has no
  numpy fallback and no ``-march=native``; a library of another host's
  key (``platform.node()`` changed) is built anew, not loaded.
* The shards read back through ``data/frozen.py`` exactly as JAX's
  loader reads them, and the layout and ``meta.json`` equal those of
  ``scripts/make_frozen_mmnist.py``.
* ``parity_eval`` against ``scripts/jax_parity_eval.py``: the same
  weights (JAX's init, converted) and the same 16x16 corpus, 4 test
  videos, 4 -> 4 and 4 -> 6 frames: the same keys, each per-horizon MSE,
  PSNR and SSIM to 1e-5 (absolute plus relative, as the recipe's eval
  step in tests/test_torch_port_recipe.py).
* ``checked_odeint`` against JAX's checkify version: on clean fields its
  (ys, stats) are ``odeint_aux``'s bit for bit and JAX's to 1e-5 of the
  largest magnitude (tests/test_torch_port_solvers.py's bound), the NFE
  equal; a field that turns NaN at t = 0.5 is flagged by both, the port
  naming that time; a solution that overflows is flagged.
* ``StepTimer`` and ``Tracker`` against JAX's on the same fed clock (the
  summaries equal); ``trace`` writes a Chrome trace holding the
  ``annotate`` span.
* ``chip_smoke.py``'s rule for a profiler window (``window_complete``):
  whole only with ``reps`` times the most device events a call that any
  trace shows (``events_a_call``), a count another trace confirms.
"""

import ast
import ctypes
import ctypes.util
import functools
import importlib.util
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_flax
from ode_rl_torch import make_frozen_mmnist, parity_eval
from ode_rl_torch.core.checkpoint import CheckpointManager
from ode_rl_torch.core.config import load_config
from ode_rl_torch.core.debug import checked_odeint
from ode_rl_torch.core.profiler import StepTimer, Tracker, annotate, trace
from ode_rl_torch.data import native_gen
from ode_rl_torch.data.frozen import FrozenMovingMNIST
from ode_rl_torch.data.mmnist import render_per_digit
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.ode.solvers import odeint_aux
from ode_rl_torch.train.step import create_train_state

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS_ARGS = ["--videos", "256", "--frames", "200", "--train_split", "0.75"]

# --- A reference of native/mmnist_gen.cc ---------------------------------

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _name, _n in (("sinf", 1), ("cosf", 1), ("fmaf", 3)):
    getattr(_LIBM, _name).argtypes = [ctypes.c_float] * _n
    getattr(_LIBM, _name).restype = ctypes.c_float
_M64 = (1 << 64) - 1
_F = np.float32


def reference_draws(seed: int, batch: int, n_frames: int, num_digits: int,
                    n_sprites: int, fma: bool):
    """(sprite_idx (B, D), positions (B, D, T, 2) (top, left)) as the C++
    generator computes them, the step y + vy * kStep * (t + 1) rounded
    twice, or once (an FMA) where ``fma``."""
    idx = np.zeros((batch, num_digits), np.int64)
    pos = np.zeros((batch, num_digits, n_frames, 2), np.int32)
    ts = np.arange(1, n_frames + 1).astype(_F)
    for b in range(batch):
        state = seed ^ ((0xD1B54A32D192ED03 * (b + 1)) & _M64)

        def splitmix64():
            nonlocal state
            state = (state + 0x9E3779B97F4A7C15) & _M64
            z = state
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
            return z ^ (z >> 31)

        uniform = lambda: _F(float(splitmix64() >> 11)) * _F(2.0 ** -53)
        for d in range(num_digits):
            x, y = uniform(), uniform()
            theta = uniform() * _F(6.2831853)
            vy, vx = _F(_LIBM.sinf(theta)), _F(_LIBM.cosf(theta))
            idx[b, d] = splitmix64() % n_sprites
            for k, (p0, v) in enumerate(((y, vy), (x, vx))):
                step = v * _F(0.1)
                q = (np.array([_LIBM.fmaf(step, t, p0) for t in ts], _F)
                     if fma else p0 + step * ts)
                m = np.fmod(q, _F(2.0))
                m = np.where(m < 0, m + _F(2.0), m).astype(_F)
                pos[b, d, :, k] = ((_F(1.0) - np.abs(m - _F(1.0)))
                                   * _F(36.0)).astype(np.int32)
    return idx, pos


def render_uint8(bank: np.ndarray, idx: np.ndarray, pos: np.ndarray,
                 chunk: int = 16):
    """The (B, T, 64, 64) uint8 frames of the draws, ``chunk`` videos at a
    time."""
    t_bank = torch.from_numpy(bank).float()
    for b0 in range(0, len(idx), chunk):
        yield b0, render_per_digit(
            t_bank, torch.from_numpy(idx[b0:b0 + chunk]),
            torch.from_numpy(pos[b0:b0 + chunk])).amax(dim=1).to(
                torch.uint8).numpy()


def _chip_smoke_constant(name: str):
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _chip_smoke_function(name: str, *needs: str):
    """A top-level function of chip_smoke.py, compiled with the functions
    it calls (``needs``) and nothing else: the script needs a card to
    import its phases' state."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    nodes = [node for node in tree.body if isinstance(node, ast.FunctionDef)
             and node.name in (name, *needs)]
    assert len(nodes) == 1 + len(needs), (name, needs)
    scope = {}
    exec(compile(ast.Module(nodes, []), "chip_smoke.py", "exec"), scope)
    return scope[name]


SHORT = ((1, 3), (2, 6), (5, 15))
DEAD = ((1, 0), (2, 0), (5, 0))


@pytest.mark.parametrize("events,traces,whole", [
    (60, SHORT, True), (20, ((1, 1), (2, 2), (5, 5)), True),
    # Events dropped from the window, or a window dropped whole.
    (59, SHORT, False), (57, SHORT, False), (0, SHORT, False),
    (17, ((1, 1), (2, 2), (5, 5)), False),
    # More than the calls launch.
    (61, SHORT, False),
    # Short traces that lost every event: a window counts once another
    # window agrees with it, and not beside a fuller one.
    (20, DEAD, False), (20, (*DEAD, (20, 20)), True),
    (20, (*DEAD, (20, 17)), False), (20, (*DEAD, (20, 40)), False),
    (0, (*DEAD, (20, 0)), False)])
def test_device_us_takes_only_whole_windows(events, traces, whole):
    """chip_smoke.device_us keeps a profiler window of 20 calls only when
    it holds 20 times the most device events a call that any trace of the
    function shows, and another trace shows that count too."""
    window_complete = _chip_smoke_function("window_complete",
                                           "events_a_call")
    assert window_complete(events, traces, 20) is whole


@pytest.mark.parametrize("counts,a_call", [
    (((1, 1), (2, 2), (5, 5)), 1), (((1, 5), (2, 10), (5, 25)), 5),
    # The one-call trace lost its event, or 3 of its 5.
    (((1, 0), (2, 2), (5, 5)), 1), (((1, 2), (2, 10), (5, 25)), 5),
    # Traces that no longer divide by their calls lost events: not read.
    (((1, 5), (2, 9), (5, 23)), 5), (((1, 0), (2, 1), (5, 4)), 0),
    ((), 0)])
def test_device_us_counts_one_call_from_short_traces(counts, a_call):
    """The events of one call: the most whole per-call count of the
    traces of 1, 2 and 5 calls, since a trace only loses events."""
    assert _chip_smoke_function("events_a_call")(counts) == a_call


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    digests = make_frozen_mmnist.main(["--out", str(out), *CORPUS_ARGS])
    return out, digests


def test_corpus_matches_the_reference_and_its_digests(corpus):
    from ode_rl_tpu.data.native_gen import generate_batch as jax_generate
    from ode_rl_tpu.data.native_gen import using_native

    out, digests = corpus
    assert digests == _chip_smoke_constant("CORPUS_SHA256")
    assert json.loads((out / "meta.json").read_text()) == {
        "videos": 256, "frames": 200, "digits": 3, "seed": 0,
        "train_videos": 192, "shard_size": 500}
    bank = get_sprite_bank()
    assert using_native()
    differ = []
    for seed, name, n in ((0, "train/shard_0000.npy", 192),
                          (1, "test/shard_0001.npy", 64)):
        shard = np.load(out / name)
        assert shard.shape == (n, 200, 64, 64) and shard.dtype == np.uint8
        idx, pos = reference_draws(seed, n, 200, 3, len(bank), fma=False)
        idx_f, pos_f = reference_draws(seed, n, 200, 3, len(bank), fma=True)
        assert np.array_equal(idx, idx_f)
        theirs = jax_generate(bank, seed=seed, batch=n, n_frames=200,
                              num_digits=3)
        fused = dict(render_uint8(bank, idx_f, pos_f))
        for b0, ref in render_uint8(bank, idx, pos):
            assert np.array_equal(shard[b0:b0 + len(ref)], ref), b0
            agree = (pos[b0:b0 + len(ref)] == pos_f[b0:b0 + len(ref)]).all(
                axis=(1, 2, 3))
            jax_part = theirs[b0:b0 + len(ref)]
            assert np.array_equal(jax_part[agree], ref[agree])
            assert np.array_equal(jax_part, fused[b0])
            differ += [(name, b0 + i) for i in np.nonzero(
                (jax_part != ref).any(axis=(1, 2, 3)))[0]]
    # The finding recorded in ROADMAP queue 3: JAX's FMA moves one video.
    assert differ == [("train/shard_0000.npy", 46)]


def test_shards_read_back_as_jax_reads_them(tmp_path, monkeypatch):
    from ode_rl_tpu.data.frozen import FrozenMovingMNIST as JaxFrozen

    ours = tmp_path / "port"
    make_frozen_mmnist.main(["--out", str(ours), "--videos", "10",
                             "--frames", "30", "--shard_size", "4",
                             "--digits", "2"])
    assert sorted(str(p.relative_to(ours)) for p in ours.rglob("*.npy")) == [
        "test/shard_0002.npy", "train/shard_0000.npy",
        "train/shard_0001.npy"]
    spec = importlib.util.spec_from_file_location(
        "jax_make_frozen", REPO / "scripts" / "make_frozen_mmnist.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    theirs = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", [
        "make_frozen_mmnist.py", "--out", str(theirs), "--videos", "10",
        "--frames", "30", "--shard_size", "4", "--digits", "2"])
    script.main()
    assert json.loads((ours / "meta.json").read_text()) == json.loads(
        (theirs / "meta.json").read_text())
    for p in theirs.rglob("*.npy"):
        a, b = np.load(p), np.load(ours / p.relative_to(theirs))
        assert a.shape == b.shape and a.dtype == b.dtype
    for train in (True, False):
        port = FrozenMovingMNIST(ours, 3, 5, 5, is_train=train, seed=4)
        ref = JaxFrozen(ours, 3, 5, 5, is_train=train, seed=4)
        for _ in range(3):
            assert np.array_equal(next(port).numpy(), np.asarray(next(ref)))


def test_bridge_raises_and_has_no_fallback(tmp_path):
    assert "-ffp-contract=off" in native_gen.FLAGS
    assert not any(f.startswith("-march") for f in native_gen.FLAGS)
    assert not hasattr(native_gen, "_numpy_fallback")
    with pytest.raises(native_gen.NativeBuildError, match="no generator"):
        native_gen.NativeGenerator(source=tmp_path / "missing.cc",
                                   build_dir=tmp_path)
    bad = tmp_path / "bad.cc"
    bad.write_text("extern \"C\" void mmnist_generate( {\n")
    with pytest.raises(native_gen.NativeBuildError, match="error"):
        native_gen.NativeGenerator(source=bad, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))
    with pytest.raises(native_gen.NativeBuildError, match="compiler"):
        native_gen.NativeGenerator(build_dir=tmp_path,
                                   cxx="no-such-compiler-here")


def test_a_library_of_another_host_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(native_gen.platform, "node", lambda: "host-a")
    first = native_gen.NativeGenerator(build_dir=tmp_path)
    assert first.build_seconds > 0 and first.path.parent == tmp_path
    again = native_gen.NativeGenerator(build_dir=tmp_path)
    assert again.path == first.path and again.build_seconds == 0.0
    monkeypatch.setattr(native_gen.platform, "node", lambda: "host-b")
    other = native_gen.NativeGenerator(build_dir=tmp_path)
    assert other.path != first.path and other.build_seconds > 0
    assert first.path.exists()
    bank = get_sprite_bank()
    assert np.array_equal(first.generate(bank, 5, 3, 7, 2),
                          other.generate(bank, 5, 3, 7, 2))
    assert native_gen.BUILD_DIR == REPO / "build" / "native"


# --- parity_eval ----------------------------------------------------------

RECIPE = ["defaults", "train_mmnist_odecgru_len20_1ch"]
NARROW = dict(conv_encoder_out_ch=16, neural_ode_decoder_out_ch=16,
              neural_ode_n_units=16, batch_size=2, train_in_seq=4,
              train_out_seq=4)


def _tiny_corpus(root: pathlib.Path) -> pathlib.Path:
    rng = np.random.RandomState(0)
    for split, n in (("train", 2), ("test", 4)):
        (root / split).mkdir(parents=True)
        np.save(root / split / "shard_0000.npy",
                rng.randint(0, 256, (n, 12, 16, 16), dtype=np.uint8))
    return root


def test_parity_eval_matches_jax_script(tmp_path, monkeypatch):
    from ode_rl_tpu.core.checkpoint import CheckpointManager as JaxCkpt
    from ode_rl_tpu.core.config import load_config as jax_load
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch
    from ode_rl_tpu.models.registry import build_model as jax_build
    import ode_rl_tpu.train.step as jax_step

    data = _tiny_corpus(tmp_path / "data")
    logs = tmp_path / "logs"
    jcfg = jax_load(RECIPE, overrides=NARROW)
    model = jax_build(jcfg)
    sample = jax_batch(jnp.zeros((2, 8, 16, 16, 1)), n_in=4)
    params = jax.jit(functools.partial(model.init, method=model.loss))(
        jax.random.key(0), sample)["params"]
    tx = jax_step.make_optimizer(jcfg)
    JaxCkpt(logs / "ODEConv" / "jax_run" / "checkpoints", tag="par_jax").save(
        1, {"params": params, "model_state": {}, "opt_state": tx.init(params)},
        config=jcfg.to_dict())
    # The script's template state, from the jitted init above (its own
    # init is not jitted: many seconds on the CPU for the same tree).
    monkeypatch.setattr(jax_step, "create_train_state", lambda m, c, b, r:
                        jax_step.TrainState(step=0, params=params,
                                            model_state={},
                                            opt_state=tx.init(params), tx=tx))
    args = ["--data", str(data), "--logdir", str(logs), "--n_in", "4",
            "--eval_outs", "4,6", "--eval_videos", "4", "--batch", "2"]
    spec = importlib.util.spec_from_file_location(
        "jax_parity_eval", REPO / "scripts" / "jax_parity_eval.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["jax_parity_eval.py", *args,
                                      "--ckpt_id", "par_jax", "--out",
                                      str(tmp_path / "jax")])
    script.main()
    ref = json.loads((tmp_path / "jax" / "metrics.json").read_text())

    cfg = load_config(RECIPE, overrides=NARROW)
    state = create_train_state(cfg, torch.device("cpu"))
    load_flax(state.model, params)
    CheckpointManager(logs / "ODEConv" / "port_run" / "checkpoints",
                      tag="par_port").save(
        1, {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}, config=cfg.to_dict())
    ours = parity_eval.main([*args, "--ckpt_id", "par_port", "--out",
                             str(tmp_path / "port"), "--device", "cpu"])
    assert json.loads((tmp_path / "port" / "metrics.json").read_text()) == \
        ours
    ode = json.loads((tmp_path / "port" / "ode.json").read_text())
    assert set(ode) == {"4to4", "4to6"}
    for solves in ode.values():
        assert 0 < solves["max_accepted"] <= solves["max_attempts"] <= 128
        assert solves["max_nfe"] >= 6 * solves["max_accepted"]
        assert solves["unconverged"] == 0
    assert set(ours) == set(ref) == {"ckpt_id", "step", "4to4", "4to6"}
    assert ours["step"] == ref["step"] == 1
    for horizon in ("4to4", "4to6"):
        assert set(ours[horizon]) == set(ref[horizon]) == {"mse", "psnr",
                                                           "ssim"}
        for k in ref[horizon]:
            np.testing.assert_allclose(ours[horizon][k], ref[horizon][k],
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="test videos"):
        parity_eval.main([*args[:-4], "--eval_videos", "5", "--ckpt_id",
                          "par_port", "--device", "cpu", "--out",
                          str(tmp_path / "x")])


# --- checked_odeint ---------------------------------------------------------

def _jax_checked(field, y0, ts, **kw):
    from jax.experimental import checkify
    from ode_rl_tpu.core.debug import checked_odeint as jax_checked

    err, out = checkify.checkify(lambda y: jax_checked(
        field, y, jnp.asarray(ts), **kw))(jnp.asarray(y0))
    return err, out


@pytest.mark.parametrize("method", ["euler", "rk4", "dopri5"])
def test_checked_odeint_clean_matches_odeint_aux_and_jax(method):
    y0 = np.array([1.0, -0.5, 2.0], np.float32)
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    port_field = lambda t, y: -y + torch.sin(torch.as_tensor(t) + y)
    ours, stats = checked_odeint(port_field, torch.from_numpy(y0), ts,
                                 method=method)
    plain, plain_stats = odeint_aux(port_field, torch.from_numpy(y0), ts,
                                    method=method)
    assert torch.equal(ours, plain) and stats == plain_stats
    err, (ref, ref_stats) = _jax_checked(lambda t, y: -y + jnp.sin(t + y),
                                         y0, ts, method=method)
    err.throw()
    # tests/test_torch_port_solvers.py's bound: 1e-5 of the largest
    # magnitude (here 2).
    assert np.max(np.abs(ours.numpy() - np.asarray(ref))) <= 2e-5
    assert int(stats.nfe) == int(ref_stats.nfe)


def test_checked_odeint_flags_a_nan_field_and_an_overflow():
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    nan_after = lambda xp: lambda t, y: xp.where(
        xp.asarray(t) >= 0.5, y * np.nan, -y)
    err, _ = _jax_checked(nan_after(jnp), np.ones(2, np.float32), ts,
                          method="euler")
    assert "non-finite dynamics output at t=0.5" in str(err.get())
    with pytest.raises(FloatingPointError, match=r"at t=0\.5"):
        checked_odeint(nan_after(torch), torch.ones(2), ts, method="euler")
    with pytest.raises(FloatingPointError, match="solution"):
        # A finite field whose first step leaves fp32's range.
        checked_odeint(lambda t, y: torch.full_like(y, 3e38),
                       torch.full((2,), 3e38), ts, method="euler")


# --- profiler ---------------------------------------------------------------

def _fed_clock(monkeypatch):
    times = iter(np.cumsum([0.0, 0.5, 0.25, 0.125, 0.3, 0.2, 0.1, 0.4,
                            0.35, 0.05]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(times))


def test_step_timer_and_tracker_match_jax(monkeypatch):
    from ode_rl_tpu.core.profiler import StepTimer as JTimer
    from ode_rl_tpu.core.profiler import Tracker as JTracker

    summaries = []
    for timer in (JTimer(warmup=3), StepTimer(warmup=3)):
        _fed_clock(monkeypatch)
        assert timer.summary() == {}
        for _ in range(10):
            timer.tick()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert set(summaries[1]) == {"mean_ms", "p50_ms", "p95_ms",
                                 "steps_per_sec"}
    for tracker in (JTracker(), Tracker()):
        tracker.write_info("a", 1)
        tracker.write_info("b", [2])
        snapshot = tracker.export_info()
        tracker.clean_info()
        assert snapshot == {"a": 1, "b": [2]} and tracker.export_info() == {}


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with trace(tmp_path / "t") as prof:
        with annotate("checked_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name") == "checked_step"
               for e in events["traceEvents"])
    with trace(tmp_path / "off", enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
