"""The port's ResNet-18 image encoder (models/resnet.py) against the JAX
package's (go_with_the_flows_tpu/models/resnet.py) from the same weights
(through utils/flax_import.resnet_to_sd) on the same images: 32 x 32
images, B=4, in the JAX package's NHWC and the port's NCHW.

- the forward in eval mode (running statistics) and in train mode
  (batch statistics), and the running statistics a train-mode call
  leaves (mean and Bessel-corrected var blended with momentum 0.9 in the
  flax convention);
- the initialisers: the port draws kaiming-normal fan_out convolutions
  and a LeCun-truncated-normal fc from its generator; their spread is
  held to the JAX package's at a loose statistical bound (the two
  frameworks cannot share an RNG), and one seed gives the same weights
  twice;
- resnet_to_sd covers every tensor of the port's module (strict load).

Tolerances: eval-mode features rtol 1e-5, atol 1e-5 (fp32, 20 layers of
convolutions summed in another order: 7.6e-6 on features up to 13);
train-mode features and running statistics rtol 1e-4, atol 1e-4, as
tests/test_torch_port_train_step.py holds a step's metrics: the batch
statistics at B=4 (layer 4 normalises over 4 values a channel) divide
by small variances, which magnifies the convolutions' last-bit
differences (7.8e-5 on features up to 1.7, 1.0e-5 on the statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.models.resnet import ResNet18 as JResNet18
from go_with_the_flows_tpu_torch.models.resnet import ResNet18
from go_with_the_flows_tpu_torch.utils.flax_import import resnet_to_sd

B, H, W, G = 4, 32, 32, 16


def _running_stats(tree, rng):
    """Running means N(0, 0.3) and variances in [0.5, 1.5), so that the
    eval-mode features are not all cut by the head's ReLU."""
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.3, tree["mean"].shape).astype(
                    np.float32),
                "var": (0.5 + rng.rand(*tree["var"].shape)).astype(
                    np.float32)}
    return {k: _running_stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_resnet():
    """Seeded weights and statistics, images, and the JAX outputs: eval
    features, train features and the running statistics after the
    train-mode call."""
    rng = np.random.RandomState(0)
    images = rng.randn(B, 4, H, W).astype(np.float32)
    nhwc = jnp.asarray(images.transpose(0, 2, 3, 1))
    jm = JResNet18(num_classes=G)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        nhwc)
    variables = {
        "params": jax.tree.map(
            lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
                np.float32), v["params"]),
        "batch_stats": _running_stats(v["batch_stats"], rng),
    }
    eval_out = jm.apply(variables, nhwc, train=False)
    assert (np.asarray(eval_out) > 0).mean() > 0.2
    train_out, mutated = jm.apply(variables, nhwc, train=True,
                                  mutable=["batch_stats"])
    return dict(images=images, variables=variables,
                init=jax.tree.map(np.asarray, v["params"]),
                eval=np.asarray(eval_out), train=np.asarray(train_out),
                stats=jax.tree.map(np.asarray, mutated["batch_stats"]))


def _port(variables):
    sd = {}
    resnet_to_sd(sd, "net", variables["params"], variables["batch_stats"])
    model = ResNet18(num_classes=G)
    model.load_state_dict({k[len("net."):]: v for k, v in sd.items()},
                          strict=True)
    return model


def test_resnet_eval_forward_matches_jax(jax_resnet):
    model = _port(jax_resnet["variables"]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(jax_resnet["images"])).numpy()
    np.testing.assert_allclose(got, jax_resnet["eval"], rtol=1e-5, atol=1e-5)


def test_resnet_train_forward_and_running_stats_match_jax(jax_resnet):
    model = _port(jax_resnet["variables"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(jax_resnet["images"])).numpy()
    np.testing.assert_allclose(got, jax_resnet["train"], rtol=1e-4,
                               atol=1e-4)
    want = {}
    resnet_to_sd(want, "net", jax_resnet["variables"]["params"],
                 jax_resnet["stats"])
    before = _port(jax_resnet["variables"]).state_dict()
    moved = 0
    for name, buf in model.named_buffers():
        ref = want["net." + name].numpy()
        np.testing.assert_allclose(buf.numpy(), ref, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        moved += not torch.equal(buf, before[name])
    assert moved == len(list(model.buffers()))


def test_resnet_layout_and_initialisers(jax_resnet):
    """Module names, NCHW shapes, the draws' spreads, and the seed."""
    a = ResNet18(num_classes=G, generator=torch.Generator().manual_seed(3))
    b = ResNet18(num_classes=G, generator=torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    out = a(torch.zeros(2, 4, H, W))
    assert out.shape == (2, G)
    init = jax_resnet["init"]
    sd = a.state_dict()
    for port_name, j in (("conv1.weight", init["conv1"]["kernel"]),
                         ("layer2_0.conv1.weight",
                          init["layer2_0"]["conv1"]["kernel"]),
                         ("layer4_1.conv2.weight",
                          init["layer4_1"]["conv2"]["kernel"]),
                         ("fc.weight", init["fc"]["kernel"])):
        got = sd[port_name].numpy()
        assert got.size == j.size
        np.testing.assert_allclose(got.std(), j.std(), rtol=0.1,
                                   err_msg=port_name)
    assert np.abs(sd["fc.weight"].numpy()).max() <= 2 / 0.8796 / np.sqrt(512)
    assert not sd["fc.bias"].any()
    assert "layer1_0.downsample_conv.weight" not in sd
    assert "layer2_0.downsample_conv.weight" in sd
