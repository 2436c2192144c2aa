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
from go_with_the_flows_tpu_torch.ops.kernels.train_decode import (
    film_ab_train,
    fused_train_decode,
    pack_point_decoder_train,
    train_decode_bwd,
    train_decode_bwd_plain,
    train_decode_fwd,
    train_decode_fwd_plain,
)
from go_with_the_flows_tpu_torch.optim import make_optimizer
from go_with_the_flows_tpu_torch.train.step import (
    make_sample_step,
    make_train_step,
)

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


def _train_decode_inputs(device, f, B, N, seed, n_flows=2, K=2):
    """Packed train-mode arrays of a K-component decoder whose weights are
    moved off their near-identity init, FiLM affines for a random latent,
    and a state p (K, B, 3, N)."""
    gen = torch.Generator().manual_seed(seed)
    model = FlowMixtureModel(n_components=K, g_latent_space_size=12,
                             g_prior_n_flows=1, p_decoder_n_flows=n_flows,
                             p_decoder_n_features=f, params_reduce_mode="none",
                             generator=gen)
    with torch.no_grad():
        for q in model.pc_decoder.parameters():
            q.add_(0.05 * torch.randn(q.shape, generator=gen))
    dec = model.pc_decoder.to(device)
    packed = {k: v.detach() for k, v in pack_point_decoder_train(dec).items()}
    g = torch.randn(B, 12, generator=gen).to(device)
    ab, _ = film_ab_train(packed, g)
    p = (0.5 * torch.randn(K, B, 3, N, generator=gen)).to(device)
    return packed, ab.detach(), p


def _rel_err(got, want):
    return ((got - want).abs().max() / (want.abs().max() + 1e-12)).item()


@pytest.mark.parametrize("f,B,N", [(8, 3, 333), (37, 4, 700), (64, 2, 129)])
def test_train_decode_fwd_kernel(device, f, B, N):
    """Kernel 7 against its plain version at ragged N: p0, the logvar sum
    and the saved states atol 1e-4, the batch statistics rtol 1e-5
    (atol 1e-5 for entries near 0); two launches give equal bits."""
    packed, ab, p = _train_decode_inputs(device, f, B, N, f)
    got = train_decode_fwd(packed, ab, p)
    want = train_decode_fwd_plain(packed, ab, p)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5)
    again = train_decode_fwd(packed, ab, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("f,B,N", [(8, 3, 333), (37, 4, 700), (64, 2, 129),
                                   (37, 3, 1000), (5, 3, 1000)])
def test_train_decode_bwd_kernel(device, f, B, N):
    """Kernel 8 against its plain version on the same residuals: the input
    cotangent within 1e-3 of its largest entry, within 3e-3 in norm, and
    at most 3e-4 of its entries beyond 1e-3 of its largest; every packed
    array's and ab's gradient within 3e-2 of its own; two launches give
    equal bits. N=1000 is not a multiple of the 512-point segments of the
    hidden pass and its dW1 product, f=37 and f=5 are padded to 40 and 8."""
    packed, ab, p = _train_decode_inputs(device, f, B, N, f + 1)
    _, _, xsave, stats = train_decode_fwd(packed, ab, p)
    gen = torch.Generator(device=device).manual_seed(f)
    dp0 = torch.randn(p.shape, device=device, generator=gen)
    dlv = torch.randn(p.shape, device=device, generator=gen)
    got = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, stats, dp0,
                                            dlv)
    assert _rel_err(got[0], dp) < 1e-3
    assert ((got[0] - dp).norm() / dp.norm()).item() <= 3e-3
    far = (got[0] - dp).abs() > 1e-3 * dp.abs().max()
    assert far.float().mean().item() <= 3e-4
    for k, want in grads.items():
        assert _rel_err(got[1][k], want) < 3e-2, k
    assert _rel_err(got[2], dab) < 3e-2
    again = train_decode_bwd(packed, ab, xsave, stats, dp0, dlv)
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    for k in grads:
        assert torch.equal(got[1][k], again[1][k]), k


def test_fused_train_decode_autograd(device):
    """fused_train_decode through autograd (kernels 7 and 8) against the
    plain pair on the same input."""
    packed, ab, p = _train_decode_inputs(device, 37, 3, 500, 5)
    leaves = {k: v.clone().requires_grad_() for k, v in packed.items()}
    ab_l, p_l = ab.clone().requires_grad_(), p.clone().requires_grad_()
    gen = torch.Generator(device=device).manual_seed(6)
    wp = torch.randn(p.shape, device=device, generator=gen)
    wl = torch.randn(p.shape, device=device, generator=gen)
    p0, lv, stats = fused_train_decode(leaves, ab_l, p_l)
    ((p0 * wp).sum() + (lv * wl).sum()).backward()
    want_p0, want_lv, xsave, want_stats = train_decode_fwd_plain(packed, ab, p)
    torch.testing.assert_close(p0, want_p0, rtol=0, atol=1e-4)
    torch.testing.assert_close(lv, want_lv, rtol=0, atol=1e-4)
    assert not stats.requires_grad
    dp, grads, dab = train_decode_bwd_plain(packed, ab, xsave, want_stats,
                                            wp, wl)
    assert _rel_err(p_l.grad, dp) < 1e-3
    assert _rel_err(ab_l.grad, dab) < 3e-2
    for k, want in grads.items():
        assert _rel_err(leaves[k].grad, want) < 3e-2, k


def test_train_step_kernel_matches_plain(device):
    """One make_train_step step through the kernels against one through
    the decoder's modules, from the same state and noise: metrics rtol
    1e-4, BatchNorm buffers atol 1e-4, parameters atol 5e-4."""
    import copy

    config = dict(n_components=2, g_latent_space_size=12, g_prior_n_flows=2,
                  g_prior_n_features=8, p_decoder_n_flows=2,
                  p_decoder_n_features=8, pc_enc_init_n_features=8,
                  pc_enc_n_features=(8, 16))
    hp = dict(epoch_length=10, cycle_length=2, min_lr=1e-4, max_lr=1e-4,
              beta1=0.9, min_beta2=0.99, max_beta2=0.99, wd=1e-6)
    base = FlowMixtureModel(**config,
                            generator=torch.Generator().manual_seed(7))
    gen = torch.Generator(device=device).manual_seed(8)
    clouds = 0.3 * torch.randn(4, 3, 300, device=device, generator=gen)
    eps = torch.randn(4, 12, device=device, generator=gen)
    out = []
    for fused in (True, False):
        model = copy.deepcopy(base).to(device)
        step = make_train_step(model, make_optimizer(
            list(model.parameters()), **hp), fused_decoder=fused)
        launches = train_decode_fwd.launches
        metrics = step(clouds, clouds, posterior_eps=eps)
        assert (train_decode_fwd.launches - launches) == int(fused)
        out.append((metrics, model.state_dict()))
    (mk, sk), (mp, sp) = out
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
    buffers = {name for name, _ in base.named_buffers()}
    for name in sk:
        atol = 1e-4 if name in buffers else 5e-4
        torch.testing.assert_close(sk[name], sp[name], rtol=0, atol=atol,
                                   msg=name)


def test_train_decode_rejects_what_it_does_not_take(device):
    packed, ab, p = _train_decode_inputs(device, 8, 2, 50, 9)
    with pytest.raises(ValueError, match="ab shape"):
        train_decode_fwd(packed, ab[:, :1], p)
    with pytest.raises(ValueError):
        train_decode_fwd(packed, ab.cpu(), p)  # CPU and CUDA mixed
    with pytest.raises(ValueError):
        train_decode_fwd(packed, ab, p.double())
    wide, wide_ab, wide_p = _train_decode_inputs(device, 72, 2, 50, 10)
    with pytest.raises(ValueError, match="shared-memory"):
        train_decode_fwd(wide, wide_ab, wide_p)
    _, _, xsave, stats = train_decode_fwd(packed, ab, p)
    with pytest.raises(ValueError, match="shape"):
        train_decode_bwd(packed, ab, xsave[:, 1:], stats, p, p)
