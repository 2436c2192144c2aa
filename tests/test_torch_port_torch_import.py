"""Importing the reference's PyTorch checkpoints into the port
(utils/torch_import.py, cli/import_torch_ckpt.py) on the CPU.

The reference tree is not needed: a reference-format state_dict is made
from a tiny JAX model's variables (K=2, the `depth_and_feature`
reduction, jiggled weights and BatchNorm statistics) by an inverse kept
here (`reference_state_dict`: the port's names back to the reference's,
the K decoders split, SharedDot tensors given their leading 1, the
ResNet's block names, num_batches_tracked added). The JAX package's own
mapping, `mixture_variables_from_state_dict`, must give the variables
back exactly, in both decoder layouts: that holds the inverse to the
reference's format as the JAX package reads it. Then the port's import
of that state_dict must equal `state_dict_from_flax` of the same
variables bit for bit, for FlowMixtureModel and FlowMixtureSVRModel.

The imported model's autoencoding encode and training decode (eval-mode
BatchNorm) match the JAX model's at rtol 1e-5 (atol 1e-6 for entries
near 0): the same fp32 operations. The CLI round trip writes a
protocol-4 pickle with DDP's `module.` keys, imports it and runs
evaluate_ae on the imported experiment; keys that do not map fail with
their names.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.models.flows import unrolled_to_scanned_params
from go_with_the_flows_tpu.models.mixture import (
    FlowMixtureModel as JFlowMixtureModel,
    FlowMixtureSVRModel as JFlowMixtureSVRModel,
)
from go_with_the_flows_tpu.utils.torch_import import (
    mixture_variables_from_state_dict,
)
from go_with_the_flows_tpu_torch.cli import evaluate_ae, import_torch_ckpt
from go_with_the_flows_tpu_torch.data.synthetic import (
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu_torch.models.mixture import (
    FlowMixtureModel,
    FlowMixtureSVRModel,
    reduce_decoder_params,
)
from go_with_the_flows_tpu_torch.ops.layers import SharedDot
from go_with_the_flows_tpu_torch.train.checkpoints import _ckpt_dir
from go_with_the_flows_tpu_torch.utils.config import (
    model_config_kwargs,
    write_config,
)
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax
from go_with_the_flows_tpu_torch.utils.torch_import import (
    state_dict_from_reference,
)

CONFIG = dict(
    n_components=2, params_reduce_mode="depth_and_feature",
    weights_type="learned_weights", g_latent_space_size=16,
    g_prior_n_flows=2, g_prior_n_features=8, g_posterior_n_layers=1, p_latent_space_size=3, p_prior_n_layers=1,
    p_decoder_n_flows=3, p_decoder_n_features=8,
    p_decoder_base_type="free", p_decoder_base_var=-3.9551,
    pc_enc_init_n_features=8, pc_enc_n_features=(8, 16),
)
SVR_CONFIG = dict(CONFIG, p_decoder_base_type="freevar", g_prior_n_layers=1)
B, N, HW = 3, 32, 32


def reference_state_dict(model, prefix=""):
    """The port's model as the reference's state_dict: every key under
    `prefix` (DDP's "module."), the decoders `pc_decoder.{k}.`, SharedDot
    tensors (1, ...), the ResNet's `layer{l}.{b}` and `downsample.{0,1}`,
    and a num_batches_tracked beside every BatchNorm."""
    dots = {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, SharedDot) for p in ("weight", "bias")
            if getattr(m, p) is not None}
    out = {}

    def put(key, value):
        if key.startswith("img_encoder.layer"):
            head, block, rest = key.split(".", 2)
            stage, b = block[len("layer"):].split("_")
            rest = rest.replace("downsample_conv.", "downsample.0.").replace(
                "downsample_bn.", "downsample.1.")
            key = f"{head}.layer{stage}.{b}.{rest}"
        out[prefix + key] = value.clone()
        if key.endswith(".running_mean"):
            out[prefix + key[:-len("running_mean")] + "num_batches_tracked"] \
                = torch.tensor(5)

    for key, value in model.state_dict().items():
        if key.startswith("pc_decoder."):
            for k in range(model.n_components):
                v = value[k][None] if key in dots else value[k]
                put(f"pc_decoder.{k}.{key[len('pc_decoder.'):]}", v)
        else:
            put(key, value[None] if key in dots else value)
    return out


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _scanned(variables, config):
    """The unrolled variables in the scanned decoder layout."""
    depth, _ = reduce_decoder_params(
        config["n_components"], config["params_reduce_mode"],
        config["p_decoder_n_flows"], config["p_decoder_n_features"],
        config["g_latent_space_size"])
    out = {}
    for part, tree in variables.items():
        dec = tree["pc_decoder"]
        comps = [jax.tree.map(np.asarray, unrolled_to_scanned_params(
            jax.tree.map(lambda a: a[k], dec), depth))
            for k in range(config["n_components"])]
        out[part] = dict(tree, pc_decoder=_stack(comps))
    return out


@functools.lru_cache(maxsize=None)
def _variables(svr):
    """A tiny JAX model's variables (unrolled decoder layout), weights
    jiggled N(0, 0.02) and BatchNorm statistics drawn."""
    rng = np.random.RandomState(7 + svr)
    config = SVR_CONFIG if svr else CONFIG
    g = jnp.asarray(rng.randn(B, 3, N).astype(np.float32))
    key = jax.random.PRNGKey(3)
    if svr:
        jm = JFlowMixtureSVRModel(**config, scan_couplings=False)
        im = jnp.asarray(rng.randn(B, HW, HW, 4).astype(np.float32))
        v = jax.jit(lambda g, im: jm.init({"params": key, "sample": key}, g,
                                          g, images=im, mode="training"))(
            g, im)
    else:
        jm = JFlowMixtureModel(**config, scan_couplings=False)
        v = jax.jit(functools.partial(jm.init, mode="training"))(
            {"params": key, "sample": key}, g, g)
    return jm, {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": _running_stats(v["batch_stats"], rng),
    }


def _running_stats(tree, rng):
    """Running means N(0, 0.3) and variances in [0.5, 1.5)."""
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.3, tree["mean"].shape).astype(
                    np.float32),
                "var": (0.5 + rng.rand(*tree["var"].shape)).astype(
                    np.float32)}
    return {k: _running_stats(v, rng) for k, v in tree.items()}


def _port(svr, sd=None):
    config = SVR_CONFIG if svr else CONFIG
    port = (FlowMixtureSVRModel if svr else FlowMixtureModel)(**config)
    if sd is not None:
        port.load_state_dict(sd, strict=True)
    return port


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("svr", [False, True], ids=["ae", "svr"])
def test_reference_format_round_trips(svr):
    """JAX variables -> the port's state_dict -> the reference's format:
    the JAX package's mapping gives the variables back exactly, in both
    decoder layouts, and the port's import gives the port's state_dict
    back bit for bit."""
    config = SVR_CONFIG if svr else CONFIG
    _, unrolled = _variables(svr)
    want = state_dict_from_flax(unrolled, config)
    ref = reference_state_dict(_port(svr, want), prefix="")
    for scan, variables in ((False, unrolled),
                            (True, _scanned(unrolled, config))):
        got = mixture_variables_from_state_dict(ref, config, svr=svr,
                                                scan_couplings=scan)
        _assert_trees_equal(jax.tree.map(np.asarray, got), variables)
        # the port takes either layout's variables to the same state_dict
        flax_sd = state_dict_from_flax(variables, config)
        assert all(torch.equal(flax_sd[k], want[k]) for k in want)
    imported = state_dict_from_reference(ref, config, svr=svr)
    assert sorted(imported) == sorted(want)
    for key, value in want.items():
        assert imported[key].dtype == value.dtype, key
        assert torch.equal(imported[key], value), key


def test_imported_model_matches_jax():
    """The imported model's autoencoding encode and its training decode
    with eval-mode BatchNorm (the K decoders' inverse) against the JAX
    model's on the same clouds."""
    jm, variables = _variables(False)
    ref = reference_state_dict(_port(False, state_dict_from_flax(variables,
                                                                 CONFIG)),
                               prefix="module.")
    port = _port(False, state_dict_from_reference(ref, CONFIG)).eval()
    rng = np.random.RandomState(11)
    g_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    p_in = (rng.randn(B, 3, N) * 0.4).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, variables)
    want_enc = jm.apply(jv, jnp.asarray(g_in), "autoencoding", train=False,
                        method="encode")
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(g_in), "autoencoding")
        dec = port.decode_training(torch.from_numpy(p_in), enc["g_sample"])
    for k in ("g_sample", "g0_sample", "g_prior_logvar_sum",
              "g_posterior_mus", "g_posterior_logvars"):
        np.testing.assert_allclose(enc[k].numpy(), np.asarray(want_enc[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want_dec = jm.apply(jv, jnp.asarray(p_in), want_enc["g_sample"], False,
                        False, method="decode_training")
    for k in ("p0_samples", "p_logvar_sums", "p_base_mus", "p_base_logvars",
              "mixture_weights_logits"):
        np.testing.assert_allclose(dec[k].numpy(), np.asarray(want_dec[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_keys_that_do_not_map_are_named():
    port = _port(False)
    ref = reference_state_dict(port, prefix="module.")
    ref["module.extra_head.weight"] = torch.zeros(3)
    dropped = "module.pc_decoder.1.flows.0.nvp1.T_mu_0.mu_sd0.weight"
    del ref[dropped]
    with pytest.raises(ValueError) as err:
        state_dict_from_reference(ref, CONFIG, model=port)
    text = str(err.value)
    assert "module.extra_head.weight" in text
    assert "pc_decoder.flows.0.nvp1.T_mu_0.mu_sd0.weight" in text
    assert "lacks components [1]" in text
    # a SharedDot tensor without its leading 1, and a plain model's
    # checkpoint read as an SVR model's
    ref = reference_state_dict(port)
    ref["pc_encoder.features.init_sd.weight"] = \
        ref["pc_encoder.features.init_sd.weight"][0]
    with pytest.raises(ValueError, match="init_sd.weight .* leading 1"):
        state_dict_from_reference(ref, CONFIG, model=port)
    with pytest.raises(ValueError, match="img_encoder.conv1.weight"):
        state_dict_from_reference(reference_state_dict(port), SVR_CONFIG,
                                  svr=True)


def test_import_cli_then_evaluate(tmp_path):
    """A protocol-4 pickle with `module.` keys -> cli/import_torch_ckpt ->
    evaluate_ae autoencoding on the imported experiment: the restored
    model is the one exported, epoch and iter carried over."""
    from test_torch_port_cli import TINY_CONFIG

    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_meshes_h5(str(data / "meshes.h5"), n_shapes=4)
    config = dict(TINY_CONFIG, path2data=str(data),
                  path2save=str(tmp_path / "results"))
    write_config(config, str(tmp_path / "config.yaml"))
    source = FlowMixtureModel(**model_config_kwargs(config),
                              generator=torch.Generator().manual_seed(4))
    torch.save({"epoch": 7, "iter": 13,
                "model_state": reference_state_dict(source, "module."),
                "optimizer_state": {}},
               str(tmp_path / "ref.pkl"), pickle_protocol=4)
    out = tmp_path / "imported"
    model, epoch, it = import_torch_ckpt.main([
        str(tmp_path / "ref.pkl"), str(tmp_path / "config.yaml"), str(out),
        "--model_name", "ref_model.ckpt", "--device", "cpu"])
    assert (epoch, it) == (7, 13)
    saved = torch.load(os.path.join(_ckpt_dir(str(out), "ref_model.ckpt"),
                                    "checkpoint.pt"), weights_only=True)
    assert (saved["epoch"], saved["iter"]) == (7, 13)
    restored, (res,) = evaluate_ae.main([
        str(out), "ref_model.ckpt", "test", "32", "32", "autoencoding",
        "--cd", "--batch_size", "4", "--device", "cpu"])
    for key, value in source.state_dict().items():
        assert torch.equal(restored.state_dict()[key], value), key
    assert np.isfinite(res["cd"])
