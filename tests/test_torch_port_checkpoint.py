"""``core/checkpoint.py`` of the port: a round trip restores equal model
and optimizer state (exactly), ``keep`` removes the oldest snapshots,
``latest_step`` and ``find_checkpoint`` find the newest, a snapshot of
another architecture raises, and the files follow the JAX package's
naming, so that its manager and ``find_checkpoint`` read the same steps
and directory."""

import pytest
import torch

from ode_rl_torch.core.checkpoint import CheckpointManager, find_checkpoint


def _state(width=8, seed=0, steps=2):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, width),
                                torch.nn.Linear(width, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for _ in range(steps):
        opt.zero_grad()
        model(torch.randn(3, 4)).square().sum().backward()
        opt.step()
    return model, opt


def _snapshot(model, opt):
    return {"model": model.state_dict(), "optimizer": opt.state_dict()}


def test_round_trip_restores_model_and_optimizer(tmp_path):
    model, opt = _state()
    mgr = CheckpointManager(tmp_path, tag="run")
    mgr.save(7, _snapshot(model, opt), config={"lr": 1e-3, "n": (1, 2)})

    fresh, fresh_opt = _state(seed=1, steps=0)
    restored = mgr.restore(_snapshot(fresh, fresh_opt))
    assert restored["step"] == 7
    fresh.load_state_dict(restored["state"]["model"])
    fresh_opt.load_state_dict(restored["state"]["optimizer"])
    for a, b in zip(model.state_dict().values(),
                    fresh.state_dict().values()):
        assert torch.equal(a, b)
    ours, theirs = opt.state_dict(), fresh_opt.state_dict()
    assert ours["param_groups"] == theirs["param_groups"]
    for i, s in ours["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(theirs["state"][i][k])), k
    assert mgr.load_config() == {"lr": 1e-3, "n": [1, 2]}


def test_keep_gc_latest_and_find(tmp_path):
    from ode_rl_tpu.core.checkpoint import (
        CheckpointManager as JaxManager, find_checkpoint as jax_find)

    model, opt = _state()
    run = tmp_path / "ODEConv" / "run_10_10" / "checkpoints"
    mgr = CheckpointManager(run, tag="tag", keep=2)
    for step in (5, 10, 15, 20):
        mgr.save(step, _snapshot(model, opt))
    assert mgr.all_steps() == [15, 20] and mgr.latest_step() == 20
    assert not list(run.glob("*.tmp"))
    # Another tag in the same directory is not this manager's.
    CheckpointManager(run, tag="tag_b").save(99, _snapshot(model, opt))
    assert mgr.all_steps() == [15, 20]
    assert JaxManager(run, tag="tag").all_steps() == [15, 20]
    assert find_checkpoint(tmp_path, "ODEConv", "tag") == run
    assert jax_find(tmp_path, "ODEConv", "tag") == run
    with pytest.raises(FileNotFoundError, match="ckpt_id='other'"):
        find_checkpoint(tmp_path, "ODEConv", "other")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore({})


def test_snapshot_of_another_architecture_raises(tmp_path):
    model, opt = _state(width=8)
    mgr = CheckpointManager(tmp_path, tag="run")
    mgr.save(1, _snapshot(model, opt))
    wider, wider_opt = _state(width=16, steps=0)
    with pytest.raises(ValueError, match="structurally incompatible"):
        mgr.restore(_snapshot(wider, wider_opt))
    deeper = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                 torch.nn.Linear(8, 2), torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="structurally incompatible"):
        mgr.restore({"model": deeper.state_dict(),
                     "optimizer": torch.optim.Adam(
                         deeper.parameters()).state_dict()})


def test_allow_missing_keeps_the_targets_field(tmp_path):
    model, opt = _state()
    mgr = CheckpointManager(tmp_path, tag="run")
    mgr.save(3, {"model": model.state_dict()})
    target = _snapshot(*_state(seed=2, steps=0))
    with pytest.raises(ValueError, match="/optimizer"):
        mgr.restore(target)
    restored = mgr.restore(target, allow_missing=("optimizer",))
    assert restored["state"]["optimizer"] is target["optimizer"]


def test_payload_loads_with_weights_only(tmp_path):
    model, opt = _state()
    path = CheckpointManager(tmp_path, tag="run").save(
        1, _snapshot(model, opt))
    raw = torch.load(path, weights_only=True)
    assert raw["step"] == 1 and set(raw["state"]) == {"model", "optimizer"}
