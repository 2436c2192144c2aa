"""Properties of the port that are not about numbers: it (and
chip_smoke.py) loads no jax and no module of the JAX package, its
flagship dict is the airplane YAML's model keys, its precision modes
keep PyTorch's fp32 switches at fp32, CPU tensors never launch a kernel (the EMD gradient
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


PREPROCESS_AND_TOOLS = (
    "data.objmesh", "data.png", "cli.preprocess_shapenetcore",
    "cli.preprocess_shapenetall", "cli.resample_shapenetcore",
    "tools.protocol_bench", "tools.train_breakdown",
)


def test_preprocessing_and_tools_import_without_jax_cv2_pandas_h5py():
    """The offline preprocessing and the two measuring tools import, and
    build their parsers, with jax, flax, cv2, pandas and h5py blocked
    (None in sys.modules: importing them raises), as on the card's
    machine, which lacks them; scipy, which the OBJ merge imports when it
    runs, is not loaded by the import either."""
    names = ["go_with_the_flows_tpu_torch." + n for n in PREPROCESS_AND_TOOLS]
    code = (
        "import importlib, sys\n"
        "blocked = ('jax', 'flax', 'cv2', 'pandas', 'h5py')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "names = sys.argv[1:]\n"
        "for name in names:\n"
        "    module = importlib.import_module(name)\n"
        "    if hasattr(module, 'define_options_parser'):\n"
        "        module.define_options_parser()\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in blocked + %r + ('scipy',)]\n"
        "assert not loaded, loaded\n"
        "print(len(names))\n") % (FORBIDDEN,)
    out = subprocess.run([sys.executable, "-c", code] + names, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(PREPROCESS_AND_TOOLS)


VIZ_AND_AB_TOOLS = (
    "viz", "viz.tb", "viz.open3d_utils", "tools.train_convergence_ab",
    "tools.svr_quality_ab",
)


def test_viz_and_ab_tools_import_without_jax_cv2_pandas_h5py_matplotlib():
    """The figures (viz/) and the two training A/B tools import, and
    build their parsers, with jax, flax, cv2, pandas, h5py, matplotlib
    and open3d blocked (None in sys.modules), as on the card's machine;
    none of them loads scipy either, and have_open3d() says False."""
    names = ["go_with_the_flows_tpu_torch." + n for n in VIZ_AND_AB_TOOLS]
    code = (
        "import importlib, sys\n"
        "blocked = ('jax', 'flax', 'cv2', 'pandas', 'h5py', 'matplotlib',\n"
        "           'open3d')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "names = sys.argv[1:]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from go_with_the_flows_tpu_torch.tools import (\n"
        "    svr_quality_ab, train_convergence_ab)\n"
        "from go_with_the_flows_tpu_torch.viz import open3d_utils\n"
        "for tool in (svr_quality_ab, train_convergence_ab):\n"
        "    try:\n"
        "        tool.main(['--help'])\n"
        "    except SystemExit:\n"
        "        pass\n"
        "assert not open3d_utils.have_open3d()\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and m.split('.')[0] in blocked + %r + ('scipy',)]\n"
        "assert not loaded, loaded\n"
        "print(len(names))\n") % (FORBIDDEN,)
    out = subprocess.run([sys.executable, "-c", code] + names, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) == len(VIZ_AND_AB_TOOLS)


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


@pytest.mark.parametrize("mode", ["highest", "high", "fast", "default"])
def test_precision_modes_keep_the_fp32_switches(mode):
    """Every mode keeps PyTorch's three fp32 switches at fp32 (none of
    the modes is TF32); an unknown name raises."""
    assert precision.get_matmul_precision() == "highest"
    with precision.matmul_precision_scope(mode):
        assert precision.get_matmul_precision() == (
            "fast" if mode == "default" else mode)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    assert precision.get_matmul_precision() == "highest"
    with pytest.raises(ValueError):
        precision.set_matmul_precision("tf32")


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
    the fourth, the training slice the fifth, which later became a
    header of kernels and four units that include it (the entry points
    and one per precision mode, so that their nvcc runs go on at once);
    that header includes the tensor-core step's (mma_bf16.cuh)."""
    names = sorted(os.path.basename(s) for s in build.sources())
    assert names == ["emd.cu", "mma_bf16.cuh", "nn_distance.cu",
                     "pairwise_cd.cu", "point_decode.cu", "train_decode.cu",
                     "train_decode.cuh", "train_decode_fast.cu",
                     "train_decode_high.cu", "train_decode_highest.cu"]
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
