"""Configuration (counterpart of go_with_the_flows_tpu/utils/config.py).

The card's machine has no YAML library, so `load_config` and
`dump_config` read and write the subset of YAML that configs/*.yaml and
`yaml.safe_dump` of a flat config use, with code of their own: one
`key: value` line per key, block lists (`- item` lines after `key:`),
`[]`, `true` / `false`, `null`, decimal ints, floats in YAML 1.1's forms
(`1.0e-06`, `.inf`, `.nan`), plain strings and single-quoted strings
(`jobid: '1'` stays a string). Any other line raises ValueError: the
reader does not guess. `resolve_config` applies the CLIs' overrides as
the JAX package does, writing `logging_path` back into the config file.

The model keys of the two configurations that chip_smoke.py runs are
also Python dicts: FLAGSHIP_AIRPLANE holds those of
configs/config_generative_modeling_airplane.yaml, SVR_SHAPENETALL13
those of configs/config_SVR.yaml (with SVR_RUN, its batch, cloud and
image sizes and optimizer keys).
"""

from __future__ import annotations

import math
import os
import re
from datetime import datetime
from typing import Dict, Optional

from torch import nn

# YAML 1.1 scalars as PyYAML's safe loader resolves them. A plain scalar
# that matches _OTHER_TAGGED (a bool, number or timestamp form outside
# the subset, or anything starting with a digit) is refused, not read as
# a string
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_NULL = ("null", "~", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
                  ".nan": math.nan}
_OTHER_TAGGED = re.compile(
    r"(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|y|Y|n|N"
    r"|[-+]?\.?[0-9].*|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)|<<|=)")
# plain (unquoted) strings the reader takes and the writer leaves plain
_PLAIN = re.compile(r"[A-Za-z_./][A-Za-z0-9_./-]*")


def _is_name(key) -> bool:
    """A key both readers take as this string (`on` or `null` would be a
    bool or None to PyYAML)."""
    return (isinstance(key, str) and bool(_KEY.fullmatch(key))
            and key not in _NULL and key not in _BOOL
            and not _OTHER_TAGGED.fullmatch(key))


def _scalar(text: str, where: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if len(text) >= 2 and text[0] == text[-1] == "'":
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: unbalanced single quotes: {text!r}")
        return body.replace("''", "'")
    if _PLAIN.fullmatch(text) and not _OTHER_TAGGED.fullmatch(text):
        return text
    raise ValueError(f"{where}: value {text!r} is outside the YAML subset "
                     "this reader takes")


def parse_config(text: str, source: str = "<config>") -> Dict:
    """A flat config from YAML text in the subset the module docstring
    names; ValueError on anything else."""
    config: Dict = {}
    list_key: Optional[str] = None  # the `key:` whose items may follow
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        line = raw.rstrip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("- "):
            if list_key is None:
                raise ValueError(f"{where}: a list item outside a list")
            if config[list_key] is None:
                config[list_key] = []
            config[list_key].append(_scalar(line[2:].strip(), where))
            continue
        list_key = None
        key, sep, value = line.partition(":")
        if not sep or not _is_name(key) or (value and value[0] != " "):
            raise ValueError(f"{where}: not a `key: value` line: {raw!r}")
        if key in config:
            raise ValueError(f"{where}: duplicate key {key!r}")
        value = value.strip()
        if value == "":  # null, unless `- item` lines follow
            config[key] = None
            list_key = key
        elif value == "[]":
            config[key] = []
        else:
            config[key] = _scalar(value, where)
    return config


def load_config(path: str) -> Dict:
    with open(path, "r") as f:
        return parse_config(f.read(), path)


def _format_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # PyYAML's float representer
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _PLAIN.fullmatch(value) and not _OTHER_TAGGED.fullmatch(value) \
                and value not in _NULL and value not in _BOOL:
            return value
        if "\n" in value:
            raise ValueError(f"cannot write a string with a newline: "
                             f"{value!r}")
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} into a "
                    "flat config")


def dump_config(config: Dict) -> str:
    """YAML text of a flat config, keys sorted, as `yaml.safe_dump` lays
    out such a config; `parse_config` and `yaml.safe_load` read it back
    equal."""
    lines = []
    for key in sorted(config):
        if not _is_name(key):
            raise ValueError(f"config key {key!r} is not a plain name")
        value = config[key]
        if isinstance(value, (list, tuple)):
            if not value:
                lines.append(f"{key}: []")
                continue
            lines.append(f"{key}:")
            lines.extend(f"- {_format_scalar(v)}" for v in value)
        else:
            lines.append(f"{key}: {_format_scalar(value)}")
    return "\n".join(lines) + "\n"


def write_config(config: Dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(dump_config(config))


def resolve_config(
    config: Dict,
    modelname: str,
    n_epochs: Optional[int] = None,
    lr: Optional[float] = None,
    weights_type: Optional[str] = None,
    jobid: str = "1",
    resume: bool = False,
    resume_optimizer: bool = False,
    cloud_random_rotate: Optional[bool] = None,
    config_path: Optional[str] = None,
    **extra,
) -> Dict:
    """The reference's CLI-over-YAML overrides (train_ae.py:47-66): jobid,
    a generated logging_path (written back into the config file at
    `config_path`), model_name, n_epochs, min_lr = max_lr = lr, the
    resume flags, weights_type, cloud_random_rotate. `extra` keys (such
    as profile_dir) are added and never written back."""
    config = dict(config)
    config["jobid"] = jobid
    if "logging_path" not in config:
        ext = jobid if jobid != "" else datetime.now().strftime(
            "%Y%m%d_%H%M%S")
        config["logging_path"] = os.path.join(config["path2save"],
                                              f"{modelname}_{ext}")
        if config_path is not None:
            write_config(config, config_path)
    config["model_name"] = f"{modelname}.ckpt"
    if n_epochs is not None:
        config["n_epochs"] = n_epochs
    if lr is not None:
        config["min_lr"] = config["max_lr"] = lr
    if weights_type is not None:
        config["weights_type"] = weights_type
    if cloud_random_rotate is not None:
        config["cloud_random_rotate"] = cloud_random_rotate
    config["resume"] = bool(resume)
    config["resume_optimizer"] = bool(resume_optimizer)
    config.update(extra)
    return config

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
