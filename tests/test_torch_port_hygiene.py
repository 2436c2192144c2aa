"""Properties of the port that are not about numbers: it (and
chip_smoke.py) loads no jax and no module of the JAX package, its
flagship dict is the airplane YAML's model keys, its precision is
fp32 'highest', CPU tensors never launch a kernel (the EMD gradient
included), and its weight converter is the inverse of the JAX package's
torch importer."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from go_with_the_flows_tpu.utils.torch_import import (
    mixture_variables_from_state_dict,
)
from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops import precision
from go_with_the_flows_tpu_torch.ops.kernels import build
from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
    chamfer,
    nn_distance,
)
from go_with_the_flows_tpu_torch.ops.kernels.emd import (
    emd_backward,
    emd_cost,
)
from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_cd_stats,
    pairwise_emd,
)
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    film_alpha_beta,
    point_decode,
)
from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    film_ab_train,
    fused_train_decode,
    pack_point_decoder_train,
    train_decode_bwd,
    train_decode_fwd,
)
from go_with_the_flows_tpu_torch.ops.layers import SharedDot
from go_with_the_flows_tpu_torch.utils.config import (
    FLAGSHIP_AIRPLANE,
    model_config_kwargs,
)
from go_with_the_flows_tpu_torch.utils.flax_import import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# top-level names of modules that neither the port nor chip_smoke.py may
# load: JAX, flax and the JAX package (not even its modules that load no
# JAX: the port keeps its own copies)
FORBIDDEN = ("jax", "flax", "go_with_the_flows_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import go_with_the_flows_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not loaded, loaded
print(len(names))
""" % (FORBIDDEN,)

_IMPORT_THESE = """
import importlib, sys
names = sys.argv[1:]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not loaded, loaded
print(len(names))
""" % (FORBIDDEN,)


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


CLI_AND_DATA = (
    "cli", "cli.train_ae", "cli.evaluate_ae", "cli.reconstruct_ae",
    "cli.train_svr", "data", "data.native", "data.cloud_sampling",
    "data.cloud_transforms", "data.image_transforms", "data.datasets",
    "data.loader", "data.synthetic", "utils.config",
)


def test_cli_and_data_modules_import_no_jax():
    """The entry points and the data path, imported alone, load no JAX
    and no module of the JAX package (nor h5py, yaml, cv2, scipy or
    tensorboard, which the card's machine lacks)."""
    names = ["go_with_the_flows_tpu_torch." + n for n in CLI_AND_DATA]
    code = _IMPORT_THESE + (
        "absent = ('h5py', 'yaml', 'cv2', 'scipy', 'tensorboard')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in absent]\n")
    out = subprocess.run([sys.executable, "-c", code] + names, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(CLI_AND_DATA)


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, those inside its
    functions included, names no forbidden module, and importing all of
    them loads none."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
    modules = []
    for name in sorted(names):
        try:  # `from m import f` names a function f, not a module m.f
            __import__(name)
            modules.append(name)
        except ImportError:
            pass
    assert any(m.startswith("go_with_the_flows_tpu_torch.") for m in modules)
    out = subprocess.run([sys.executable, "-c", _IMPORT_THESE] + modules,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_flagship_is_the_airplane_yaml():
    path = os.path.join(ROOT, "configs",
                        "config_generative_modeling_airplane.yaml")
    with open(path) as f:
        config = yaml.safe_load(f)
    assert model_config_kwargs(config) == FLAGSHIP_AIRPLANE


def test_flagship_decoder_widths():
    model = FlowMixtureModel(**FLAGSHIP_AIRPLANE)
    assert model.pc_decoder.n_flows == 11
    assert model.pc_decoder.f_features == 37
    assert len(model.pc_decoder.couplings()) == 33
    assert model.pc_decoder.stack == (4,)


def test_precision_is_highest_only():
    assert precision.get_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        precision.set_matmul_precision("fast")


def test_cpu_tensors_never_launch_a_kernel():
    wrappers = (point_decode, nn_distance, pairwise_cd_stats, emd_cost,
                emd_backward, pairwise_emd, train_decode_fwd,
                train_decode_bwd)
    before = [w.launches for w in wrappers]
    model = FlowMixtureModel(n_components=2, g_latent_space_size=12,
                             g_prior_n_flows=1, p_decoder_n_flows=2,
                             p_decoder_n_features=8).eval()
    packed = model.pack_decoder()
    g = torch.randn(2, 12)
    point_decode(packed, film_alpha_beta(packed, g), torch.randn(2, 2, 3, 9))
    a, b = torch.randn(2, 9, 3), torch.randn(2, 7, 3)
    nn_distance(a, b)
    chamfer(a, b)
    pairwise_cd_stats(a, b, 0.1)
    pairwise_emd(a, b)
    a.requires_grad_()
    emd_cost(a, b[:, :5]).sum().backward()
    assert a.grad.shape == a.shape
    train_packed = pack_point_decoder_train(model.pc_decoder)
    ab, _ = film_ab_train(train_packed, g)
    p0, lv, _ = fused_train_decode(train_packed, ab,
                                   torch.randn(2, 2, 3, 9))
    (p0.sum() + lv.sum()).backward()
    assert all(q.grad is not None for q in model.pc_decoder.parameters())
    assert [w.launches for w in wrappers] == before == [0] * 8


def test_kernel_sources_are_the_three_cuda_files():
    """Named for the three files of the first slice; the EMD slice added
    the fourth, the training slice the fifth."""
    names = sorted(os.path.basename(s) for s in build.sources())
    assert names == ["emd.cu", "nn_distance.cu", "pairwise_cd.cu",
                     "point_decode.cu", "train_decode.cu"]
    assert build.BUILD_DIR.endswith(os.path.join("go_with_the_flows_tpu_torch",
                                                 "_build"))


def _reference_layout(model):
    """The port's state_dict in the reference's key layout: K decoders
    under pc_decoder.{k}, SharedDot weights (1, out, in), biases (1, out)."""
    shared = {name for name, m in model.named_modules()
              if isinstance(m, SharedDot)}
    out = {}
    for key, value in model.state_dict().items():
        module = key.rpartition(".")[0]
        if key.startswith("pc_decoder."):
            copies = [(key.replace("pc_decoder.", f"pc_decoder.{k}.", 1),
                       value[k]) for k in range(model.n_components)]
        else:
            copies = [(key, value)]
        for name, v in copies:
            out[name] = v[None] if module in shared else v
    return out


@pytest.mark.parametrize("scan", [True, False])
def test_flax_import_inverts_torch_import(scan):
    config = dict(n_components=2, params_reduce_mode="depth_and_feature",
                  g_latent_space_size=12, g_prior_n_flows=2,
                  g_prior_n_features=8, g_posterior_n_layers=1,
                  p_prior_n_layers=1, p_decoder_n_flows=3,
                  p_decoder_n_features=8, p_decoder_base_type="free",
                  pc_enc_init_n_features=8, pc_enc_n_features=(8, 16))
    model = FlowMixtureModel(**config,
                             generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    variables = mixture_variables_from_state_dict(
        _reference_layout(model), config, scan_couplings=scan)
    back = state_dict_from_flax(variables, config)
    want = model.state_dict()
    assert sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(back[key].numpy(), want[key].numpy(),
                                      err_msg=key)
