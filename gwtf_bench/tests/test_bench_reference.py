"""The plain reference against the port's CPU path (its decoder's modules
under autograd) at tiny sizes: the same loss and gradients from the same
weights, inputs and noise, and the same optimizer steps."""

import numpy as np
import pytest
import torch

from gwtf_bench import run
from gwtf_bench.reference import model as ref_model
from gwtf_bench.reference.train import Amsgrad, follow

SPEC = run.Spec()
TINY = dict(n_components=2, p_decoder_n_flows=3, p_decoder_n_features=8,
            g_latent_space_size=16, g_prior_n_flows=2, g_prior_n_features=8,
            pc_enc_init_n_features=8, pc_enc_n_features=[8, 16, 16],
            batch_size=5, cloud_size=48, image_size=[32, 32])


def _tiny(cell):
    cfg = SPEC.config(SPEC.cell(cell))
    cfg.update(TINY)
    return cfg


def _port(cfg, svr):
    from go_with_the_flows_tpu_torch.models.mixture import (
        FlowMixtureModel, FlowMixtureSVRModel)
    from go_with_the_flows_tpu_torch.utils.config import (
        model_config_kwargs, svr_model_config_kwargs)

    gen = torch.Generator().manual_seed(3)
    if svr:
        return FlowMixtureSVRModel(**svr_model_config_kwargs(cfg),
                                   generator=gen)
    return FlowMixtureModel(**model_config_kwargs(cfg), generator=gen)


@pytest.mark.parametrize("cell", ["airplane.train", "svr.train"])
def test_reference_loss_and_gradients_match_the_port(cell):
    from go_with_the_flows_tpu_torch.losses import flow_mixture_loss

    cfg = _tiny(cell)
    svr = cell.startswith("svr")
    model = _port(cfg, svr).train()
    rng = np.random.default_rng(0)
    B, N, G = cfg["batch_size"], cfg["cloud_size"], cfg["g_latent_space_size"]
    g = torch.from_numpy(rng.standard_normal((B, 3, N), np.float32) * 0.2)
    p = torch.from_numpy(rng.standard_normal((B, 3, N), np.float32) * 0.2)
    eps = torch.from_numpy(rng.standard_normal((B, G), np.float32))
    images = (torch.from_numpy(rng.standard_normal((B, 4, 32, 32),
                                                   np.float32))
              if svr else None)
    weights = {n: q.detach().clone().requires_grad_(True)
               for n, q in model.named_parameters()}

    kw = {"images": images} if svr else {}
    out = model.encode(g, "training", posterior_eps=eps, **kw)
    out.update(model.decode_training(p, out["g_sample"], False, False))
    loss, _ = flow_mixture_loss(out)
    loss.backward()

    mine, _ = ref_model.training_loss(weights, g, p, eps,
                                      cfg["p_decoder_base_type"], images)
    mine.backward()
    assert float(mine.detach()) == pytest.approx(float(loss.detach()),
                                                 rel=1e-5)
    # each leaf within 1e-4 of its largest entry or of the median leaf's
    # (a bias under BatchNorm gets a gradient of round-off alone)
    grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q),
                 weights[n].grad if weights[n].grad is not None
                 else torch.zeros_like(q))
             for n, q in model.named_parameters()}
    median = float(np.median([float(w.abs().max()) for w, _ in
                              grads.values()]))
    for n, (want, got) in grads.items():
        scale = max(float(want.abs().max()), median)
        assert float((got - want).abs().max()) <= 1e-4 * scale, n


def test_reference_optimizer_matches_amsgrad_wd():
    from go_with_the_flows_tpu_torch.optim import make_optimizer

    cfg = dict(_tiny("svr.train"), min_lr=1e-3, max_lr=2e-3,
               min_beta2=0.99, max_beta2=0.999, cycle_length=2)
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(4, 3, generator=gen), torch.randn(5, generator=gen),
              torch.randn(2, generator=gen)]
    ref = {str(i): q.clone() for i, q in enumerate(params)}
    port = [q.clone().requires_grad_(True) for q in params]
    opt = make_optimizer(port, 3, **cfg)
    mine = Amsgrad(ref, cfg, 3)
    for step in range(5):
        grads = [torch.randn(q.shape, generator=gen) for q in params]
        grads[2] = grads[2] * (step % 2)  # a leaf unused every other step
        for q, d in zip(port, grads):
            q.grad = d.clone()
        opt.step()
        mine.step({str(i): d for i, d in enumerate(grads)})
    for i, q in enumerate(port):
        torch.testing.assert_close(ref[str(i)], q.detach(), rtol=1e-6,
                                   atol=1e-7)


def test_follow_leaves_the_weights_as_they_were():
    cfg = _tiny("airplane.train")
    model = _port(cfg, False)
    weights = {n: q.detach().clone() for n, q in model.named_parameters()}
    before = {n: q.clone() for n, q in weights.items()}
    gen = torch.Generator().manual_seed(1)
    B, N = cfg["batch_size"], cfg["cloud_size"]
    batches = [{"g": torch.randn(B, 3, N, generator=gen) * 0.2,
                "p": torch.randn(B, 3, N, generator=gen) * 0.2,
                "eps": torch.randn(B, 16, generator=gen)} for _ in range(2)]
    out = follow(weights, batches, cfg, 8)
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))
    assert max(out["change"].values()) > 0
    for n in weights:
        assert torch.equal(weights[n], before[n])
