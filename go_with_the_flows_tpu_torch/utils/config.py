"""Model configuration (counterpart of parts of
go_with_the_flows_tpu/utils/config.py).

The card's machine has no YAML parser, so the flagship configuration is
a Python dict here: FLAGSHIP_AIRPLANE holds the model keys of
configs/config_generative_modeling_airplane.yaml.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

MODEL_KEYS = (
    "n_components", "params_reduce_mode", "weights_type",
    "g_latent_space_size", "g_prior_n_flows", "g_prior_n_features",
    "g_posterior_n_layers", "p_latent_space_size", "p_prior_n_layers",
    "p_decoder_n_flows", "p_decoder_n_features", "p_decoder_base_type",
    "p_decoder_base_var", "pc_enc_init_n_features", "pc_enc_n_features",
)

FLAGSHIP_AIRPLANE = {
    "n_components": 4,
    "params_reduce_mode": "depth_and_feature",
    "weights_type": "learned_weights",
    "g_latent_space_size": 128,
    "g_prior_n_flows": 7,
    "g_prior_n_features": 128,
    "g_posterior_n_layers": 1,
    "p_latent_space_size": 3,
    "p_prior_n_layers": 1,
    "p_decoder_n_flows": 21,
    "p_decoder_n_features": 64,
    "p_decoder_base_type": "free",
    "p_decoder_base_var": -3.9551,
    "pc_enc_init_n_features": 64,
    "pc_enc_n_features": (128, 256, 512),
}


def model_config_kwargs(config: Dict) -> Dict:
    """FlowMixtureModel constructor kwargs from a flat config."""
    out = {k: config[k] for k in MODEL_KEYS if k in config}
    if "pc_enc_n_features" in out:
        out["pc_enc_n_features"] = tuple(out["pc_enc_n_features"])
    return out


def count_params(module: nn.Module) -> int:
    """Number of parameter elements (BatchNorm running statistics are
    buffers and do not count, as batch_stats do not in the JAX package)."""
    return sum(p.numel() for p in module.parameters())
