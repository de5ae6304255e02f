"""The port's config reader and ``Config`` against the JAX package's
(which reads ``configs.yaml`` with ``yaml.safe_load``): every block of
``configs.yaml`` equal, the recipe and test blocks merged and overridden
from the command line equal, ``coerce``, ``resolve_run_id``, and the
reader's refusals. Exact equality throughout."""

import pathlib

import pytest
import yaml

from ode_rl_torch.core import config as port
from ode_rl_tpu.core import config as ref

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs.yaml"
RECIPE = ["defaults", "train_mmnist_odecgru_len20_1ch"]
TEST = ["defaults", "test_mmnist_odecgru_len20_1ch"]


def test_reader_equals_safe_load_on_every_block():
    text = CONFIGS.read_text()
    expected = yaml.safe_load(text)
    ours = port.parse_config_blocks(text)
    assert len(ours) == len(expected) == 64
    assert list(ours) == list(expected)
    for name in expected:
        assert ours[name] == expected[name], name
        assert ({k: type(v) for k, v in ours[name].items()}
                == {k: type(v) for k, v in expected[name].items()}), name


@pytest.mark.parametrize("text", [
    "b:\n  k: 1e-4\n", "b:\n  k: 1.0e-4\n", "b:\n  k: True\n",
    "b:\n  k: 'True'\n", "b:\n  k: \"x # y\"  # c\n", "b:\n  k: [3]\n",
    "b:\n  k: [1, 2.5, 'a', off]\n", "b:\n  k: 'it''s'\n", "b:\n  k: ~\n",
    "b:\n  k: -0.5\n", "b:\n  k: .5\n", "b:\n  k: 1_000\n",
    "b:\n  k: abc def\n", "b:\n  k: 1 # one\n\n# c\n  j: 2\n",
    "b:\n", "b:\n  k: 1\n  k: 2\n"])
def test_reader_equals_safe_load_on_scalars(text):
    assert port.parse_config_blocks(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "b:\n  k:\n    j: 1\n",          # nested block
    "b:\n  k: 1\n    j: 2\n",        # deeper line
    "b:\n  - 1\n",                   # block list
    "b:\n  k: [1, [2]]\n",           # nested flow list
    "b:\n  k: {a: 1}\n",             # flow mapping
    "b:\n  k: &x 1\n",               # anchor
    "b:\n  k: !!str 1\n",            # tag
    "b:\n  k: |\n    x\n",           # block scalar
    "b:\n  k: 010\n",                # YAML 1.1 octal
    "b:\n  k: 1:30\n",               # sexagesimal
    "a: 1\n",                        # top-level scalar
    "---\nb:\n  k: 1\n",             # document marker
    "b:\n  k: 'open\n",              # unterminated quote
])
def test_reader_raises_on_what_it_does_not_understand(text):
    with pytest.raises(port.YamlError):
        port.parse_config_blocks(text)


@pytest.mark.parametrize("names,argv", [
    (RECIPE, []),
    (RECIPE, ["--lr", "3e-4", "--batch_size", "8", "--frozen", "False",
              "--ode_solver", "fast", "--odeint_rtol", "1e-3",
              "--n_hid", "1,2", "--data_dir", "/tmp/x"]),
    (TEST, ["--eval_batches", "2", "--test_out_seq", "30"]),
])
def test_load_config_and_cli_overrides_equal_jax(names, argv):
    ours = port.Config(port.add_cli_overrides(
        port.load_config(names).to_dict(), argv))
    theirs = ref.Config(ref.add_cli_overrides(
        ref.load_config(names).to_dict(), argv))
    assert ours.to_dict() == theirs.to_dict()
    assert ({k: type(v) for k, v in ours.items()}
            == {k: type(v) for k, v in theirs.items()})
    assert port.resolve_run_id(ours) == ref.resolve_run_id(theirs)


def test_load_config_overrides_and_unknown_block():
    ov = {"lr": "1e-3", "epochs": "3", "quiet": "True", "new_key": 5}
    assert (port.load_config(RECIPE, overrides=ov).to_dict()
            == ref.load_config(RECIPE, overrides=ov).to_dict())
    with pytest.raises(KeyError, match="no config block"):
        port.load_config(["defaults", "no_such_block"])


@pytest.mark.parametrize("default,text", [
    (True, "False"), (False, "1"), (True, "true"), (3, "7"), (3, "1e-3"),
    (3, "2.5"), (1.0, "3"), ((3,), "1,2"), ([300], "4"), ("a", "b"),
    (None, "x")])
def test_coerce_equals_jax(default, text):
    ours, theirs = port.coerce(default, text), ref.coerce(default, text)
    assert ours == theirs and type(ours) is type(theirs)


def test_coerce_rejects_a_bad_bool():
    with pytest.raises(Exception, match="expected bool"):
        port.coerce(True, "maybe")


def test_resolve_run_id_and_config_mapping():
    cfg = port.Config({"id": "x", "phase": "train", "train_in_seq": 10,
                       "train_out_seq": 5, "test_in_seq": 10,
                       "test_out_seq": 90})
    assert port.resolve_run_id(cfg) == "x_10_5"
    assert port.resolve_run_id(cfg.replace(phase="test")) == "x_10_90"
    assert cfg.get("missing", 3) == 3 and cfg.id == "x"
    with pytest.raises(AttributeError):
        cfg.id = "y"
    with pytest.raises(AttributeError):
        cfg.missing
    assert cfg == port.Config(cfg.to_dict())
