"""S3VAE's spatial encoders in the port against the JAX package: 'cgru',
'cgru_sa' with slot attention, 'cgru_rim' and 'odecgru', each as a whole
model (forward, the eight metrics, every gradient leaf and the BatchNorm
buffers; helpers, sizes and tolerances in tests/test_torch_port_s3vae.py),
and eval on the whole sequence (t_in + n_out frames) with the swap probes.

The 'odecgru' dynamic head's dopri5 rollout (64 steps at most) is held at
the same tolerances: at these sizes its solve converges within the budget.
Where the budget runs out, the unreached slots hold the final state and
fp32 noise moves it (ROADMAP queue 3, "Truncated solves"); the card's
reference step (chip_smoke.py phase 11) holds the full-width block.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_util import max_abs, t32
from test_torch_port_s3vae import (B, OUT_TOL, T_IN, VARIANTS, Recorder,
                                   Replay, configs, jax_init, load_port,
                                   model_parity, video)
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.models.registry import build_model

SPATIAL = [v for v in VARIANTS if not v[0].startswith("default")]


@pytest.mark.parametrize("name,block,train,grad_ref", SPATIAL,
                         ids=[v[0] for v in SPATIAL])
def test_spatial_s3vae_matches_jax(name, block, train, grad_ref,
                                   monkeypatch):
    port, _ = model_parity(block, monkeypatch, train=train,
                           grad_ref=grad_ref)
    names = {n for n, _ in port.named_parameters()}
    if name == "odecgru":
        # The rollout field keeps HWIO (kernels K1/K2); z0's head gives
        # 2 * d_zt channels.
        assert "dynamic_rnn.ode_func.mid_2.kernel" in names
        assert port.dynamic_rnn.ode_z0.head_1.weight.shape[0] == 2 * 8
    if name == "cgru_rim":
        assert port.static_rnn.cgru_rim.core.block_cgru.gates.groups == 4
    if name.startswith("cgru_sa"):
        assert port.use_slots and port.mu_slot_att.conv_input


def test_swap_probes_and_eval_rollout(monkeypatch):
    """Eval on the whole sequence (t_in + n_out frames) with the swap
    probes, against JAX's ``predict(train=False, swap=True)``."""
    from ode_rl_tpu.data.protocol import make_batch_dict as jax_batch

    jcfg, cfg = configs("train_mmnist_recon_cs3vae")
    v = video(1, 32, t=T_IN + 4)
    jb = jax_batch(jnp.asarray(v), n_in=T_IN, with_flow_labels=True)
    model, variables = jax_init(jcfg, jb)
    rec = Recorder()
    rec.patch(monkeypatch)
    j_pred, j_aux = jax.jit(lambda b: model.apply(
        variables, b, train=False, swap=True, method=model.predict,
        rngs={"sample": jax.random.key(3)}))(jb)
    monkeypatch.undo()
    port = build_model(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    load_port(port, variables)
    port.eval()
    with torch.no_grad():
        pred, aux = port.predict(make_batch_dict(t32(v), T_IN), Replay(
            rec.draws), swap=True)
    assert pred.shape == (B, T_IN + 4, 32, 32, 1) == j_pred.shape
    assert max_abs(pred, j_pred) <= OUT_TOL
    for k in ("x_swap_motion", "x_swap_content", "zt", "prior_mu",
              "dfp_logits"):
        assert max_abs(aux[k], j_aux[k]) <= OUT_TOL, k


