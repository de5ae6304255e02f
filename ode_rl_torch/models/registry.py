"""Model registry: config -> module.

Counterpart of ``ode_rl_tpu/models/registry.py``. The port builds
``model: ODEConv``; every other family of the JAX registry raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

import torch

from ode_rl_torch.models.odeconvgru import ODEConvGRUModel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Families of the JAX registry that are not ported, and where they stand
# in ROADMAP queue 1.
_NOT_PORTED = {
    "ConvGRU": "item 4 (models/convgru.py)",
    "cgrudecODE": "item 4 (models/convgru.py)",
    "VidODE": "item 8 (Vid-ODE)",
    "S3VAE": "item 9 (sequential VAEs)",
    "S2VAE": "item 9 (sequential VAEs)",
    "CS2VAE": "item 9 (sequential VAEs)",
    "DS2VAE": "item 9 (sequential VAEs)",
    "ConvLSTM": "item 10 (ConvLSTM)",
    "Dreamer": "item 11 (world models)",
    "SpatialDreamer": "item 11 (world models)",
    "CATERClassifier": "item 11 (world models)",
    "DSVAE": "item 12 (sprite DS-VAE)",
}


def cfg_get(cfg, key: str, default: Any = None) -> Any:
    """``cfg.get`` for a ``Config`` and for the port's dataclasses."""
    return getattr(cfg, key, default)


def _build_odeconvgru(cfg, generator: torch.Generator) -> ODEConvGRUModel:
    if cfg_get(cfg, "mem", False):
        raise NotImplementedError("mem=True (ode/memory.py nru/nru2) is not "
                                  "ported: ROADMAP queue 1, item 5")
    if cfg_get(cfg, "z_sample", False):
        raise NotImplementedError("z_sample=True and its KL term are not "
                                  "ported: ROADMAP queue 1, item 3 (9c)")
    return ODEConvGRUModel(
        in_channels=cfg.in_channels, n_downs=cfg.n_downs,
        conv_encoder_out_ch=cfg.conv_encoder_out_ch,
        neural_ode_decoder_out_ch=cfg.neural_ode_decoder_out_ch,
        neural_ode_n_units=cfg.neural_ode_n_units,
        n_ode_layers=cfg.n_ode_layers,
        rtol=float(cfg_get(cfg, "odeint_rtol", 1e-4)),
        atol=float(cfg_get(cfg, "odeint_atol", 1e-5)),
        ode_max_steps=int(cfg_get(cfg, "ode_max_steps", 128)),
        method=cfg.decode_diff_method,
        ode_solver=cfg_get(cfg, "ode_solver", "scan"),
        ode_remat=cfg_get(cfg, "ode_remat", True),
        dtype=DTYPES[cfg_get(cfg, "compute_dtype", "float32")],
        generator=generator)


def build_model(cfg, device: torch.device,
                generator: torch.Generator) -> torch.nn.Module:
    """The module ``cfg.model`` names, initialised from ``generator`` (a
    CPU generator, so the weights do not depend on the device) and moved
    to ``device``."""
    name = cfg.model
    if name == "ODEConv":
        return _build_odeconvgru(cfg, generator).to(device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP queue 1, "
            f"{_NOT_PORTED[name]}")
    raise NotImplementedError(
        f"Model {name!r} is not implemented. Try one of "
        f"{sorted([*_NOT_PORTED, 'ODEConv'])}")
