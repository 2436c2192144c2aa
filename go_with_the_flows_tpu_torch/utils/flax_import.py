"""Carry the JAX package's weights into the port.

`state_dict_from_flax(variables, config)` turns FlowMixtureModel
variables `{"params", "batch_stats"}` (numpy leaves, or anything
np.asarray reads) into the port's state_dict. It is the inverse of
go_with_the_flows_tpu/utils/torch_import.py, with two differences: the
port's K point decoders are one module with a leading K axis
(`pc_decoder.flows.{i}.nvp{j}...`), and its SharedDot weights are
(out, in) like the flax kernels (the reference's carry a leading 1).

Both decoder layouts are accepted: the scanned default
(`periods/nvp{k}` + `tail_nvp{j}`, leaves (K, n_pairs, ...)) and the
unrolled `flow{i}_nvp{j}`. Flax Dense kernels are (in, out); the port's
Linear weights are (out, in). A FlowMixtureSVRModel's image encoder
(flax HWIO conv kernels, the port's OIHW) and g0_prior come across too.

The per-module functions take a `prefix` and add entries to `sd`, so a
test can convert one module at a time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.mixture import reduce_decoder_params


def _put(sd: Dict, key: str, value) -> None:
    sd[key] = torch.from_numpy(np.array(value, np.float32))


def _dense_t(kernel) -> np.ndarray:
    """Flax Dense kernel (..., in, out) -> Linear weight (..., out, in)."""
    return np.swapaxes(np.asarray(kernel), -1, -2)


def batch_norm_to_sd(sd, prefix, params, stats, affine: bool = True):
    if affine:
        _put(sd, f"{prefix}.weight", params["scale"])
        _put(sd, f"{prefix}.bias", params["bias"])
    _put(sd, f"{prefix}.running_mean", stats["mean"])
    _put(sd, f"{prefix}.running_var", stats["var"])


def _film_to_sd(sd, prefix, short, params, stats):
    _put(sd, f"{prefix}.{short}0.weight", _dense_t(params["film0"]["kernel"]))
    batch_norm_to_sd(sd, f"{prefix}.{short}0_bn", params["film0_bn"],
                     stats["film0_bn"])
    _put(sd, f"{prefix}.{short}1.weight", _dense_t(params["film1"]["kernel"]))
    _put(sd, f"{prefix}.{short}1.bias", params["film1"]["bias"])


def point_coupling_to_sd(sd, prefix, params, stats):
    """CondAffineCoupling3D variables -> the port's coupling at `prefix`."""
    for head in ("mu", "logvar"):
        p, s = params[f"T_{head}"], stats[f"T_{head}"]
        t0 = f"{prefix}.T_{head}_0"
        _put(sd, f"{t0}.{head}_sd0.weight", p["sd0"]["kernel"])
        batch_norm_to_sd(sd, f"{t0}.{head}_sd0_bn", p["sd0_bn"],
                         s["sd0_bn"])
        _put(sd, f"{t0}.{head}_sd1.weight", p["sd1"]["kernel"])
        batch_norm_to_sd(sd, f"{t0}.{head}_sd1_bn", None, s["sd1_bn"],
                         affine=False)
        for n in ("w", "b"):
            _film_to_sd(sd, f"{prefix}.T_{head}_0_cond_{n}",
                        f"{head}_sd1_film_{n}", p[f"cond_{n}"],
                        s[f"cond_{n}"])
        t1 = f"{prefix}.T_{head}_1.{head}_sd2"
        _put(sd, f"{t1}.weight", p["sd2"]["kernel"])
        _put(sd, f"{t1}.bias", p["sd2"]["bias"])


def scanned_to_unrolled(tree, n_flows: int, stack_ndim: int = 0):
    """numpy re-implementation of coupling_kernel.scanned_to_unrolled_params:
    split the stacked `periods/nvp{k}` leaves (pair axis after
    `stack_ndim` leading axes) into `flow{i}_nvp{j}` entries."""
    n_pairs, tail = divmod(n_flows, 2)
    lead = (slice(None),) * stack_ndim

    def take(node, t):
        if isinstance(node, dict):
            return {k: take(v, t) for k, v in node.items()}
        return np.asarray(node)[lead + (t,)]

    out = {}
    for t in range(n_pairs):
        for k in range(6):
            flow_off, j = divmod(k, 3)
            out[f"flow{2 * t + flow_off}_nvp{j + 1}"] = take(
                tree["periods"][f"nvp{k + 1}"], t)
    if tail:
        for j in range(3):
            out[f"flow{n_flows - 1}_nvp{j + 1}"] = tree[f"tail_nvp{j + 1}"]
    return out


def point_decoder_to_sd(sd, prefix, params, stats, n_flows: int,
                        stack_ndim: int = 0):
    """PointDecoderFlow (unrolled) or ScanPointDecoderFlow variables ->
    the port's PointDecoderFlow at `prefix`."""
    if "periods" in params or "tail_nvp1" in params:
        params = scanned_to_unrolled(params, n_flows, stack_ndim)
        stats = scanned_to_unrolled(stats, n_flows, stack_ndim)
    for i in range(n_flows):
        for j in (1, 2, 3):
            name = f"flow{i}_nvp{j}"
            point_coupling_to_sd(sd, f"{prefix}.flows.{i}.nvp{j}",
                                 params[name], stats[name])


def latent_coupling_to_sd(sd, prefix, params, stats):
    """LatentAffineCoupling variables -> the port's coupling at `prefix`."""
    for h in ("mu", "logvar"):
        t0 = f"{prefix}.T_{h}_0"
        p = params[f"T_{h}"]
        _put(sd, f"{t0}.{h}_mlp0.weight", _dense_t(p["mlp0"]["kernel"]))
        batch_norm_to_sd(sd, f"{t0}.{h}_mlp0_bn", p["mlp0_bn"],
                         stats[f"T_{h}"]["mlp0_bn"])
        _put(sd, f"{t0}.{h}_mlp1.weight", _dense_t(p["mlp1"]["kernel"]))
        _put(sd, f"{t0}.{h}_mlp1.bias", p["mlp1"]["bias"])


def latent_prior_to_sd(sd, prefix, params, stats):
    """LatentPriorFlow variables -> the port's LatentPriorFlow."""
    n_flows = len([k for k in params if k.endswith("_nvp1")])
    for i in range(n_flows):
        for j in (1, 2):
            name = f"flow{i}_nvp{j}"
            latent_coupling_to_sd(sd, f"{prefix}.flows.{i}.nvp{j}",
                                  params[name], stats[name])


def feature_encoder_to_sd(sd, prefix, params, stats):
    """FeatureEncoder (or WeightsEncoder's inner `features`) variables."""
    n_layers = len([k for k in params if k.startswith("mlp")
                    and not k.endswith("_bn")])
    for i in range(n_layers):
        _put(sd, f"{prefix}.features.mlp{i}.weight",
             _dense_t(params[f"mlp{i}"]["kernel"]))
        batch_norm_to_sd(sd, f"{prefix}.features.mlp{i}_bn",
                         params[f"mlp{i}_bn"], stats[f"mlp{i}_bn"])
    _put(sd, f"{prefix}.mus.mu_mlp0.weight",
         _dense_t(params["mu_head"]["kernel"]))
    _put(sd, f"{prefix}.mus.mu_mlp0.bias", params["mu_head"]["bias"])
    if "logvar_head" in params:
        _put(sd, f"{prefix}.logvars.logvar_mlp0.weight",
             _dense_t(params["logvar_head"]["kernel"]))
        _put(sd, f"{prefix}.logvars.logvar_mlp0.bias",
             params["logvar_head"]["bias"])


def pointnet_to_sd(sd, prefix, params, stats):
    """PointNetCloudEncoder variables."""
    names = ["init_sd"] + sorted(
        (k for k in params if k.startswith("sd") and not k.endswith("_bn")),
        key=lambda k: int(k[2:]))
    for name in names:
        _put(sd, f"{prefix}.features.{name}.weight", params[name]["kernel"])
        batch_norm_to_sd(sd, f"{prefix}.features.{name}_bn",
                         params[f"{name}_bn"], stats[f"{name}_bn"])


def resnet_to_sd(sd, prefix, params, stats):
    """ResNet18 variables -> the port's ResNet18 at `prefix`. Flax conv
    kernels are HWIO, the port's OIHW."""

    def conv(name, p):
        _put(sd, f"{prefix}.{name}.weight",
             np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))

    conv("conv1", params["conv1"])
    batch_norm_to_sd(sd, f"{prefix}.bn1", params["bn1"], stats["bn1"])
    for block in sorted(k for k in params if k.startswith("layer")):
        p, s = params[block], stats[block]
        for c in ("conv1", "conv2", "downsample_conv"):
            if c in p:
                conv(f"{block}.{c}", p[c])
        for b in ("bn1", "bn2", "downsample_bn"):
            if b in p:
                batch_norm_to_sd(sd, f"{prefix}.{block}.{b}", p[b], s[b])
    _put(sd, f"{prefix}.fc.weight", _dense_t(params["fc"]["kernel"]))
    _put(sd, f"{prefix}.fc.bias", params["fc"]["bias"])
    batch_norm_to_sd(sd, f"{prefix}.fc_bn", params["fc_bn"], stats["fc_bn"])


def state_dict_from_flax(variables: Dict, config: Dict) -> Dict[str, torch.Tensor]:
    """FlowMixtureModel (or FlowMixtureSVRModel) variables -> the port's
    model state_dict. `config` holds the YAML model keys (n_components,
    params_reduce_mode, p_decoder_n_flows, p_decoder_n_features,
    g_latent_space_size)."""
    params, stats = variables["params"], variables["batch_stats"]
    depth, _ = reduce_decoder_params(
        config["n_components"], config["params_reduce_mode"],
        config["p_decoder_n_flows"], config["p_decoder_n_features"],
        config["g_latent_space_size"])
    sd: Dict[str, torch.Tensor] = {}
    pointnet_to_sd(sd, "pc_encoder", params["pc_encoder"],
                   stats["pc_encoder"])
    _put(sd, "g0_prior_mus", params["g0_prior_mus"])
    _put(sd, "g0_prior_logvars", params["g0_prior_logvars"])
    latent_prior_to_sd(sd, "g_prior", params["g_prior"], stats["g_prior"])
    feature_encoder_to_sd(sd, "g_posterior", params["g_posterior"],
                          stats["g_posterior"])
    if "p_prior" in params:
        feature_encoder_to_sd(sd, "p_prior", params["p_prior"],
                              stats["p_prior"])
    point_decoder_to_sd(sd, "pc_decoder", params["pc_decoder"],
                        stats["pc_decoder"], depth, stack_ndim=1)
    _put(sd, "mixture_weights_logits", params["mixture_weights_logits"])
    enc = "mixture_weights_encoder"
    feature_encoder_to_sd(sd, enc, params[enc]["features"],
                          stats[enc]["features"])
    if "img_encoder" in params:
        resnet_to_sd(sd, "img_encoder", params["img_encoder"],
                     stats["img_encoder"])
        feature_encoder_to_sd(sd, "g0_prior", params["g0_prior"],
                              stats["g0_prior"])
    return sd
