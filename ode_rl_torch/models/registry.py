"""Model registry: config -> module.

Counterpart of ``ode_rl_tpu/models/registry.py``. The port builds
``model: ODEConv`` (with ``mem`` and ``z_sample``), ``ConvGRU`` and
``cgrudecODE`` (``ConvGRU`` with ``decODE``); every other family of the
JAX registry raises and names the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

import torch

from ode_rl_torch.models.convgru import ConvGRUModel
from ode_rl_torch.models.odeconvgru import ODEConvGRUModel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Families of the JAX registry that are not ported, and where they stand
# in ROADMAP queue 1.
_NOT_PORTED = {
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


def _dtype(cfg) -> torch.dtype:
    return DTYPES[cfg_get(cfg, "compute_dtype", "float32")]


def _build_convgru(cfg, generator: torch.Generator) -> ConvGRUModel:
    return ConvGRUModel(
        in_channels=cfg.in_channels,
        conv_encoder_out_ch=cfg.conv_encoder_out_ch,
        convgru_out_ch=cfg.convgru_out_ch,
        decODE=cfg.model == "cgrudecODE" or cfg_get(cfg, "decODE", False),
        latent_dim=int(cfg_get(cfg, "latent_dim", 64)),
        n_ode_layers=int(cfg_get(cfg, "n_ode_layers", 2)),
        neural_ode_n_units=int(cfg_get(cfg, "neural_ode_n_units", 64)),
        method=cfg_get(cfg, "decode_diff_method", "dopri5"),
        rtol=float(cfg_get(cfg, "odeint_rtol", 1e-4)),
        atol=float(cfg_get(cfg, "odeint_atol", 1e-5)),
        ode_max_steps=int(cfg_get(cfg, "ode_max_steps", 128)),
        dtype=_dtype(cfg), generator=generator)


def _build_odeconvgru(cfg, generator: torch.Generator) -> ODEConvGRUModel:
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
        mem=cfg_get(cfg, "mem", False),
        mem_mode=str(cfg_get(cfg, "mem_mode", "nru")),
        z_sample=cfg_get(cfg, "z_sample", False),
        z_kl_weight=float(cfg_get(cfg, "z_kl_weight", 0.0)),
        dtype=_dtype(cfg), generator=generator)


_BUILDERS = {"ODEConv": _build_odeconvgru, "ConvGRU": _build_convgru,
             "cgrudecODE": _build_convgru}


def build_model(cfg, device: torch.device,
                generator: torch.Generator) -> torch.nn.Module:
    """The module ``cfg.model`` names, initialised from ``generator`` (a
    CPU generator, so the weights do not depend on the device) and moved
    to ``device``."""
    name = cfg.model
    if name in _BUILDERS:
        return _BUILDERS[name](cfg, generator).to(device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP queue 1, "
            f"{_NOT_PORTED[name]}")
    raise NotImplementedError(
        f"Model {name!r} is not implemented. Try one of "
        f"{sorted([*_NOT_PORTED, *_BUILDERS])}")
