"""Model configuration (counterpart of parts of
go_with_the_flows_tpu/utils/config.py).

The card's machine has no YAML parser, so the flagship configuration is
a Python dict here: FLAGSHIP_AIRPLANE holds the model keys of
configs/config_generative_modeling_airplane.yaml, SVR_SHAPENETALL13 those
of configs/config_SVR.yaml (with SVR_RUN, its batch, cloud and image
sizes and optimizer keys).
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


# model keys of configs/config_SVR.yaml (its img_enc_* keys are not read:
# the image encoder is a ResNet-18 at its default widths)
SVR_SHAPENETALL13 = {
    "n_components": 4,
    "params_reduce_mode": "depth_and_feature",
    "weights_type": "learned_weights",
    "g_latent_space_size": 512,
    "g_prior_n_flows": 7,
    "g_prior_n_features": 128,
    "g_prior_n_layers": 1,
    "g_posterior_n_layers": 1,
    "p_latent_space_size": 3,
    "p_prior_n_layers": 1,
    "p_decoder_n_flows": 21,
    "p_decoder_n_features": 64,
    "p_decoder_base_type": "freevar",
    "p_decoder_base_var": 0.0,
    "pc_enc_init_n_features": 64,
    "pc_enc_n_features": (128, 256, 512),
}

# run keys of configs/config_SVR.yaml: the batch, the decoder's cloud
# size, the image size (H, W) and the optimizer's keys
SVR_RUN = {
    "batch_size": 128,
    "cloud_size": 2500,
    "image_size": (224, 224),
    "cycle_length": 20,
    "min_lr": 0.000256,
    "max_lr": 0.000256,
    "beta1": 0.9,
    "min_beta2": 0.995,
    "max_beta2": 0.995,
    "wd": 1e-6,
}


def model_config_kwargs(config: Dict) -> Dict:
    """FlowMixtureModel constructor kwargs from a flat config."""
    out = {k: config[k] for k in MODEL_KEYS if k in config}
    if "pc_enc_n_features" in out:
        out["pc_enc_n_features"] = tuple(out["pc_enc_n_features"])
    return out


def svr_model_config_kwargs(config: Dict) -> Dict:
    """FlowMixtureSVRModel constructor kwargs from a flat config:
    FlowMixtureModel's and g_prior_n_layers."""
    out = model_config_kwargs(config)
    if "g_prior_n_layers" in config:
        out["g_prior_n_layers"] = config["g_prior_n_layers"]
    return out


def count_params(module: nn.Module) -> int:
    """Number of parameter elements (BatchNorm running statistics are
    buffers and do not count, as batch_stats do not in the JAX package)."""
    return sum(p.numel() for p in module.parameters())
