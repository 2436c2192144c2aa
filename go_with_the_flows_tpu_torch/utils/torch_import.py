"""Import the reference's PyTorch checkpoints into the port (counterpart
of go_with_the_flows_tpu/utils/torch_import.py, which maps them onto the
JAX package's variables).

The reference saves `torch.save({'epoch', 'iter', 'model_state',
'optimizer_state'}, path, pickle_protocol=4)`; `model_state` is the
state_dict of a `Flow_Mixture_Model` or `Flow_Mixture_SVR_Model`. The
port's modules carry the reference's names (models/flows.py), so the
mapping is key by key, with the layout differences that
utils/flax_import.py states:

  * DDP's `module.` prefix is dropped;
  * the K point decoders `pc_decoder.{k}.<rest>` are one module with a
    leading K axis, `pc_decoder.<rest>` (the K tensors stacked);
  * SharedDot weights (1, out, in) and biases (1, out) drop their
    leading 1;
  * the ResNet's blocks `img_encoder.layer{l}.{b}.<rest>` are
    `img_encoder.layer{l}_{b}.<rest>`, their shortcut `downsample.0` and
    `downsample.1` are `downsample_conv` and `downsample_bn`;
  * BatchNorm's `num_batches_tracked` has no counterpart and is dropped.

A reference key that finds no place in the port's model, a port key that
no reference key fills, and a tensor whose shape does not fit are errors
that name them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Set, Tuple

import torch

from ..models.mixture import FlowMixtureModel, FlowMixtureSVRModel
from ..ops.layers import SharedDot
from .config import model_config_kwargs, svr_model_config_kwargs

_DECODER = re.compile(r"pc_decoder\.(\d+)\.(.+)")
_BLOCK = re.compile(r"img_encoder\.layer(\d+)\.(\d+)\.(.+)")
_SHORTCUT = (("downsample.0.", "downsample_conv."),
             ("downsample.1.", "downsample_bn."))


def build_model(config: Dict, svr: bool = False,
                generator: Optional[torch.Generator] = None):
    """The port's model of a config (its YAML model keys)."""
    if svr:
        return FlowMixtureSVRModel(**svr_model_config_kwargs(config),
                                   generator=generator)
    return FlowMixtureModel(**model_config_kwargs(config),
                            generator=generator)


def port_key(ref_key: str) -> Tuple[str, Optional[int]]:
    """The port's key of a reference key, and the decoder component it
    holds (None outside the point decoders)."""
    key = ref_key[len("module."):] if ref_key.startswith("module.") \
        else ref_key
    m = _DECODER.fullmatch(key)
    if m:
        return f"pc_decoder.{m[2]}", int(m[1])
    m = _BLOCK.fullmatch(key)
    if m:
        rest = m[3]
        for old, new in _SHORTCUT:
            if rest.startswith(old):
                rest = new + rest[len(old):]
        return f"img_encoder.layer{m[1]}_{m[2]}.{rest}", None
    return key, None


def shared_dot_keys(model: torch.nn.Module) -> Set[str]:
    """The state_dict keys of the model's SharedDot weights and biases."""
    return {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, SharedDot) for p in ("weight", "bias")
            if getattr(m, p) is not None}


def state_dict_from_reference(state_dict, config: Dict, svr: bool = False,
                              model: Optional[torch.nn.Module] = None
                              ) -> Dict[str, torch.Tensor]:
    """A reference model's state_dict (tensors or numpy arrays) -> the
    port's FlowMixtureModel (with `svr`, FlowMixtureSVRModel) state_dict,
    every tensor in the port's dtype on the CPU. `model`: the port's
    model of `config`, built here when not given (it supplies the keys
    and shapes)."""
    if model is None:
        model = build_model(config, svr)
    target = model.state_dict()
    dots = shared_dot_keys(model)
    K = model.n_components
    out: Dict[str, torch.Tensor] = {}
    components: Dict[str, Dict[int, torch.Tensor]] = {}
    unmapped, bad_shapes = [], []
    for ref_key, value in state_dict.items():
        if ref_key.endswith(".num_batches_tracked"):
            continue
        key, k = port_key(ref_key)
        if key not in target or (k is None) == key.startswith("pc_decoder.") \
                or (k is not None and k >= K):
            unmapped.append(ref_key)
            continue
        value = torch.as_tensor(value).detach().cpu()
        if key in dots:
            if value.ndim == 0 or value.shape[0] != 1:
                bad_shapes.append(f"{ref_key} {tuple(value.shape)} (a "
                                  "SharedDot tensor has a leading 1)")
                continue
            value = value[0]
        if k is None:
            out[key] = value
        else:
            components.setdefault(key, {})[k] = value
    for key, parts in components.items():
        absent = [k for k in range(K) if k not in parts]
        if absent:
            bad_shapes.append(f"pc_decoder.<k>.{key[len('pc_decoder.'):]} "
                              f"lacks components {absent}")
            continue
        shapes = {tuple(parts[k].shape) for k in range(K)}
        if len(shapes) > 1:
            bad_shapes.append(f"pc_decoder.<k>.{key[len('pc_decoder.'):]} "
                              f"components of shapes {sorted(shapes)}")
            continue
        out[key] = torch.stack([parts[k] for k in range(K)])
    for key, value in out.items():
        if value.shape != target[key].shape:
            bad_shapes.append(f"{key}: {tuple(value.shape)} where the port "
                              f"has {tuple(target[key].shape)}")
    missing = sorted(set(target) - set(out))
    problems = []
    if unmapped:
        problems.append("reference keys with no place in the port's model: "
                        + ", ".join(sorted(unmapped)))
    if bad_shapes:
        problems.append("shapes that do not fit: " + "; ".join(bad_shapes))
    if missing:
        problems.append("port keys the checkpoint does not fill: "
                        + ", ".join(missing))
    if problems:
        raise ValueError("the reference checkpoint does not map onto the "
                         f"port's {type(model).__name__}:\n  "
                         + "\n  ".join(problems))
    return {key: out[key].to(target[key].dtype).contiguous()
            for key in target}


def load_reference(model: torch.nn.Module, state_dict, config: Dict,
                   svr: bool = False) -> torch.nn.Module:
    """Load a reference state_dict into the port's `model` (strict)."""
    model.load_state_dict(state_dict_from_reference(state_dict, config, svr,
                                                    model), strict=True)
    return model
