"""Model registry: config -> module.

Counterpart of ``ode_rl_tpu/models/registry.py``. The port builds
``model: ODEConv`` (with ``mem`` and ``z_sample``), ``ConvGRU``,
``cgrudecODE`` (``ConvGRU`` with ``decODE``), ``S3VAE``, ``VidODE``
(with its slot variant and ``mem``), ``ConvLSTM``, ``S2VAE``, ``CS2VAE``,
``DS2VAE``, the Sprites ``DSVAE`` and the world models ``Dreamer``
(``DreamerVideoModel``), ``SpatialDreamer`` (``SpatialWorldModel``) and
``CATERClassifier`` (``CaterClassifierModel``, which trains through its
own path, wm/cater.py), each with JAX's defaults.
"""

from __future__ import annotations

from typing import Any

import torch

from ode_rl_torch.models.convgru import ConvGRUModel
from ode_rl_torch.models.convlstm import ConvLSTMED
from ode_rl_torch.models.ds2vae import DS2VAEModel
from ode_rl_torch.models.odeconvgru import ODEConvGRUModel
from ode_rl_torch.models.s2vae import S2VAEModel
from ode_rl_torch.models.s3vae import S3VAEModel
from ode_rl_torch.models.vidode import VidODEModel
from ode_rl_torch.sprite.dsvae import DisentangledVAE

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _build_s3vae(cfg, generator: torch.Generator) -> S3VAEModel:
    """As JAX builds it: ``n_hid`` is 512 unless ``rim``; ``num_blocks``
    and ``topk`` reach only the 'cgru_rim' encoder (the vector RIM keeps
    its own 3 and 3); slots apply only to 'default' and 'cgru_sa'."""
    n_hid0 = _first(cfg_get(cfg, "n_hid", [300]))
    return S3VAEModel(
        in_channels=cfg.in_channels, d_zf=cfg.d_zf, d_zt=cfg.d_zt,
        encoder=cfg_get(cfg, "encoder", "default"),
        n_hid=int(n_hid0) if cfg_get(cfg, "rim", False) else 512,
        encoder_out_dims=cfg_get(cfg, "encoder_out_dims", 128),
        k_stat=cfg_get(cfg, "k_stat", -1),
        l0=float(cfg_get(cfg, "l0", 10.0)),
        l1=float(cfg_get(cfg, "l1", 1000.0)),
        l2=float(cfg_get(cfg, "l2", 100.0)),
        l3=float(cfg_get(cfg, "l3", 1.0)),
        margin=float(cfg_get(cfg, "m", 1.0)),
        slot_att=cfg_get(cfg, "slot_att", False),
        num_slots=cfg_get(cfg, "num_slots", 3),
        slot_size=cfg_get(cfg, "slot_size", 128),
        num_iterations=cfg_get(cfg, "num_iterations", 3),
        rim=cfg_get(cfg, "rim", False),
        unit_per_rim=cfg_get(cfg, "unit_per_rim", 100),
        rim_num_blocks=int(_first(cfg_get(cfg, "num_blocks", [4]))),
        rim_topk=int(_first(cfg_get(cfg, "topk", [3]))),
        flow_grid=cfg_get(cfg, "flow_grid", 3),
        extrapolate=cfg_get(cfg, "extrapolate", False),
        data_points=int(cfg_get(cfg, "data_points", 10000)),
        train_test_split=float(cfg_get(cfg, "train_test_split", 0.8)),
        dtype=_dtype(cfg), generator=generator)


def _build_vidode(cfg, generator: torch.Generator) -> VidODEModel:
    return VidODEModel(
        in_channels=cfg.in_channels, n_downs=cfg.n_downs,
        n_layers=cfg_get(cfg, "n_layers", 3),
        method=cfg.decode_diff_method,
        rtol=float(cfg_get(cfg, "odeint_rtol", 1e-3)),
        atol=float(cfg_get(cfg, "odeint_atol", 1e-4)),
        ode_max_steps=int(cfg_get(cfg, "ode_max_steps", 128)),
        slot_attention=bool(cfg_get(cfg, "slot_attention", False)),
        num_slots=int(cfg_get(cfg, "num_slots", 4)),
        slot_dim=int(cfg_get(cfg, "slot_dim", 32)),
        pos=int(cfg_get(cfg, "pos", 2)),
        slot_iters=int(cfg_get(cfg, "slot_iters", 3)),
        mem=bool(cfg_get(cfg, "mem", False)),
        mem_mode=str(cfg_get(cfg, "mem_mode", "nru")),
        dtype=_dtype(cfg), generator=generator)


def _build_s2vae(cfg, generator: torch.Generator) -> S2VAEModel:
    cs2vae = cfg.model == "CS2VAE"
    return S2VAEModel(
        in_channels=cfg.in_channels, d_zf=cfg_get(cfg, "d_zf", 128),
        num_slots=cfg_get(cfg, "num_slots", 3),
        slot_size=cfg_get(cfg, "slot_size", 128),
        num_iterations=cfg_get(cfg, "num_iterations", 3),
        gru_layers=cfg_get(cfg, "gru_layers", 2),
        transition="cgru" if cs2vae else cfg_get(cfg, "transition", "gru"),
        conv_mode=cs2vae, prior=cfg_get(cfg, "prior", "standard"),
        unmasked=cfg_get(cfg, "unmasked", True), dtype=_dtype(cfg),
        generator=generator)


def _build_ds2vae(cfg, generator: torch.Generator) -> DS2VAEModel:
    return DS2VAEModel(
        in_channels=cfg.in_channels, d_zf=cfg_get(cfg, "d_zf", 128),
        n_hid=int(_first(cfg_get(cfg, "n_hid", [300]))),
        num_slots=cfg_get(cfg, "num_slots", 3),
        slot_size=cfg_get(cfg, "slot_size", 128),
        num_iterations=cfg_get(cfg, "num_iterations", 3),
        num_blocks=int(_first(cfg_get(cfg, "num_blocks", [3]))),
        topk=int(_first(cfg_get(cfg, "topk", [3]))),
        dtype=_dtype(cfg), generator=generator)


def _build_dsvae(cfg, generator: torch.Generator) -> DisentangledVAE:
    return DisentangledVAE(
        f_dim=cfg_get(cfg, "f_dim", 256), z_dim=cfg_get(cfg, "z_dim", 32),
        g_dim=cfg_get(cfg, "g_dim", 128), channels=cfg.in_channels,
        hidden_dim=cfg_get(cfg, "rnn_size", 256), dtype=_dtype(cfg),
        generator=generator)


def _build_convlstm(cfg, generator: torch.Generator) -> ConvLSTMED:
    return ConvLSTMED(in_channels=cfg.in_channels, dtype=_dtype(cfg),
                      generator=generator)


def _build_dreamer(cfg, generator: torch.Generator):
    from ode_rl_torch.wm.world_model import DreamerVideoModel
    return DreamerVideoModel(
        image_shape=(cfg.resolution, cfg.resolution, cfg.in_channels),
        cnn_depth=cfg_get(cfg, "cnn_depth", 32),
        stoch=cfg_get(cfg, "dyn_stoch", 30),
        deter=cfg_get(cfg, "dyn_deter", 200),
        hidden=cfg_get(cfg, "dyn_hidden", 200),
        discrete=cfg_get(cfg, "dyn_discrete", 0),
        mean_act=cfg_get(cfg, "dyn_mean_act", "none"),
        std_act=cfg_get(cfg, "dyn_std_act", "sigmoid2"),
        min_std=float(cfg_get(cfg, "dyn_min_std", 0.1)),
        cell_norm=cfg_get(cfg, "dyn_cell",
                          "gru_layer_norm") == "gru_layer_norm",
        kl_balance=float(cfg_get(cfg, "kl_balance", 0.8)),
        kl_free=float(cfg_get(cfg, "kl_free", 1.0)),
        kl_scale=float(cfg_get(cfg, "kl_scale", 1.0)),
        dtype=_dtype(cfg), generator=generator)


def _build_spatial_dreamer(cfg, generator: torch.Generator):
    from ode_rl_torch.wm.spatial_rssm import SpatialWorldModel
    return SpatialWorldModel(
        image_shape=(cfg.resolution, cfg.resolution, cfg.in_channels),
        stoch_ch=int(cfg_get(cfg, "dyn_stoch_ch", 16)),
        deter_ch=int(cfg_get(cfg, "dyn_deter_ch", 64)),
        hidden_ch=int(cfg_get(cfg, "dyn_hidden_ch", 64)),
        embed_ch=int(cfg_get(cfg, "embed_ch", 64)),
        kl_scale=float(cfg_get(cfg, "kl_scale", 1.0)),
        kl_free=float(cfg_get(cfg, "kl_free", 1.0)),
        stochastic_gates=bool(cfg_get(cfg, "stochastic_gates", True)),
        sparsity_scale=float(cfg_get(cfg, "sparsity_scale",
                                     cfg_get(cfg, "dyn_gate_scale", 0.1))),
        gate_prior=float(cfg_get(cfg, "dyn_gate_prior", 0.3)),
        gate_free=float(cfg_get(cfg, "dyn_gate_free", 0.0)),
        dtype=_dtype(cfg), generator=generator)


def _build_cater_classifier(cfg, generator: torch.Generator):
    from ode_rl_torch.wm.cater import CaterClassifierModel
    return CaterClassifierModel(cfg, generator=generator)


_BUILDERS = {"ODEConv": _build_odeconvgru, "ConvGRU": _build_convgru,
             "cgrudecODE": _build_convgru, "S3VAE": _build_s3vae,
             "VidODE": _build_vidode, "ConvLSTM": _build_convlstm,
             "S2VAE": _build_s2vae, "CS2VAE": _build_s2vae,
             "DS2VAE": _build_ds2vae, "DSVAE": _build_dsvae,
             "Dreamer": _build_dreamer,
             "SpatialDreamer": _build_spatial_dreamer,
             "CATERClassifier": _build_cater_classifier}


def build_model(cfg, device: torch.device,
                generator: torch.Generator) -> torch.nn.Module:
    """The module ``cfg.model`` names, initialised from ``generator`` (a
    CPU generator, so the weights do not depend on the device) and moved
    to ``device``."""
    name = cfg.model
    if name in _BUILDERS:
        return _BUILDERS[name](cfg, generator).to(device)
    raise NotImplementedError(
        f"Model {name!r} is not implemented. Try one of {sorted(_BUILDERS)}")
