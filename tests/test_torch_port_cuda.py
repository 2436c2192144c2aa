"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU, nvcc and the `cuda` marker;
without a card they skip. On the card's machine, which has no jax, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(the repository's conftest.py imports jax).
"""

import pytest
import torch

from go_with_the_flows_tpu_torch.models.mixture import FlowMixtureModel
from go_with_the_flows_tpu_torch.ops.kernels.chamfer import (
    chamfer,
    nn_distance,
    nn_distance_plain,
)
from go_with_the_flows_tpu_torch.ops.kernels.emd import (
    emd_cost_kernel,
    emd_backward,
    emd_backward_plain,
    emd_cost,
    emd_cost_plain,
)
from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_cd_stats,
    pairwise_cd_stats_plain,
    pairwise_emd,
    pairwise_emd_plain,
)
from go_with_the_flows_tpu_torch.ops.kernels.point_decode import (
    film_alpha_beta,
    point_decode,
    point_decode_plain,
)
from go_with_the_flows_tpu_torch.train.step import make_sample_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("features,inverse", [(8, False), (8, True),
                                              (64, False), (64, True)])
def test_point_decode_kernel(device, features, inverse):
    model = FlowMixtureModel(n_components=2, g_latent_space_size=12,
                             g_prior_n_flows=1, p_decoder_n_flows=3,
                             p_decoder_n_features=features,
                             params_reduce_mode="none")
    model = model.to(device).eval()
    packed = model.pack_decoder()
    gen = torch.Generator(device=device).manual_seed(0)
    g = torch.randn(3, 12, device=device, generator=gen)
    ab = film_alpha_beta(packed, g)
    p = torch.randn(2, 3, 3, 333, device=device, generator=gen)
    got = point_decode(packed, ab, p, inverse)
    want = point_decode_plain(packed, ab, p, inverse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_nn_distance_kernel(device):
    gen = torch.Generator(device=device).manual_seed(1)
    a = torch.randn(3, 300, 3, device=device, generator=gen)
    b = torch.randn(3, 517, 3, device=device, generator=gen)
    got = nn_distance(a, b)
    want = nn_distance_plain(a, b)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    a.requires_grad_()
    dl, dr = chamfer(a, b)
    (dl.sum() + dr.sum()).backward()
    assert torch.isfinite(a.grad).all()


def test_pairwise_kernel(device):
    gen = torch.Generator(device=device).manual_seed(2)
    s = torch.randn(4, 300, 3, device=device, generator=gen)
    r = torch.randn(5, 1100, 3, device=device, generator=gen)
    got = pairwise_cd_stats(s, r, 0.05)
    want = pairwise_cd_stats_plain(s, r, 0.05)
    for x, y in zip(got[:2], want[:2]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=100 / 1100)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=100 / 300)


@pytest.mark.parametrize("mode", ["generating", "autoencoding"])
def test_sample_step_never_waits_for_the_card(device, mode):
    """No operation of the sampling step synchronises with the card (a
    list index, for one, is copied from the host and would)."""
    model = FlowMixtureModel(n_components=2, g_latent_space_size=12,
                             g_prior_n_flows=2, p_decoder_n_flows=2,
                             p_decoder_n_features=8).to(device).eval()
    step = make_sample_step(model, 64, mode)
    gen = torch.Generator(device=device).manual_seed(3)
    clouds = torch.randn(3, 3, 64, device=device, generator=gen)
    step(clouds, gen)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        samples, _, _ = step(clouds, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(samples).all()


@pytest.mark.parametrize("B,N,M", [(3, 50, 77), (2, 40, 100), (2, 100, 40),
                                   (64, 2048, 2048), (4, 2500, 2500)])
def test_emd_kernels(device, B, N, M):
    """Kernel 5 against its plain version (cost rtol 1e-4, the sums run in
    another order); kernel 6 against the plain backward on the kernel's
    own residuals (rtol 1e-4, atol 1e-5), reached through autograd with a
    non-uniform upstream weight."""
    gen = torch.Generator(device=device).manual_seed(B + N + M)
    a = 0.3 * torch.randn(B, N, 3, device=device, generator=gen)
    b = 0.3 * torch.randn(B, M, 3, device=device, generator=gen)
    torch.testing.assert_close(emd_cost(a, b), emd_cost_plain(a, b),
                               rtol=1e-4, atol=0)
    w = torch.rand(B, device=device, generator=gen) + 0.5
    ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
    (w * emd_cost(ga, gb)).sum().backward()
    cost, rl, rr = emd_cost_kernel(a, b, True)
    assert rl.shape == (B, 9, N) and rr.shape == (B, 9, M)
    torch.testing.assert_close(cost, emd_cost(a, b), rtol=0, atol=0)
    da, db = emd_backward_plain(a, b, rl, rr)
    torch.testing.assert_close(ga.grad, w[:, None, None] * da, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(gb.grad, w[:, None, None] * db, rtol=1e-4,
                               atol=1e-5)
    kda, kdb = emd_backward(a, b, rl, rr)
    torch.testing.assert_close(kda, da, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kdb, db, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S,R,N,M", [(5, 7, 50, 77), (3, 4, 300, 200)])
def test_pairwise_emd_kernel(device, S, R, N, M):
    """The grid equals the paired kernel on the same pairs bit for bit
    (the same device function); against the plain version rtol 2e-4,
    atol 1e-5."""
    gen = torch.Generator(device=device).manual_seed(S * R)
    s = 0.3 * torch.randn(S, N, 3, device=device, generator=gen)
    r = 0.3 * torch.randn(R, M, 3, device=device, generator=gen)
    got = pairwise_emd(s, r)
    pairs = emd_cost(s[:, None].expand(S, R, N, 3).reshape(S * R, N, 3),
                     r[None].expand(S, R, M, 3).reshape(S * R, M, 3))
    torch.testing.assert_close(got, pairs.reshape(S, R), rtol=0, atol=0)
    torch.testing.assert_close(got, pairwise_emd_plain(s, r), rtol=2e-4,
                               atol=1e-5)


def test_kernels_reject_what_they_do_not_take(device):
    a = torch.randn(2, 10, 3, device=device)
    with pytest.raises(ValueError):
        nn_distance(a, torch.randn(2, 10, 3))  # CPU and CUDA mixed
    with pytest.raises(ValueError):
        nn_distance(a.double(), a.double())
    with pytest.raises(ValueError):
        pairwise_cd_stats(a.transpose(0, 1), a, 0.1)
    with pytest.raises(ValueError):
        emd_cost(a, torch.randn(3, 10, 3, device=device))  # batch differs
    with pytest.raises(ValueError):
        pairwise_emd(a, a.double())
    big = torch.randn(1, 6000, 3, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        emd_cost(big, big)  # 288 KB of shared memory
