"""The port's metrics against the JAX package's, 6 vs 6 clouds on the
CPU (both sides in fp32 from the same numpy clouds).

Tolerances: MMD and CD rtol 1e-5 (the same per-pair minima, averaged in
another order); MMD-EMD and paired EMD rtol 1e-4 (the auction's sums run
in another order, the bound of tests/test_pallas_kernels.py); COV and
1-NNA exact (argmins and nearest neighbours of matrices that agree to
1e-4 on these sets). The voxel JSD and its histograms: 1e-12 absolute
(the same float64 histogram; the entropies summed by numpy here and by
scipy there).
"""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from go_with_the_flows_tpu.eval.evaluating import evaluate as j_evaluate
from go_with_the_flows_tpu.metrics import evaluation as jev
from go_with_the_flows_tpu_torch.eval.evaluating import evaluate as t_evaluate
from go_with_the_flows_tpu_torch.metrics import evaluation as tev

THR = 0.02  # in the bulk of the nearest-neighbour distances below


def _sets(seed, n=6, pts=32):
    rng = np.random.RandomState(seed)
    gen = (rng.randn(n, pts, 3) * 0.3).astype(np.float32)
    ref = (rng.randn(n, pts, 3) * 0.3).astype(np.float32)
    return gen, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_all_metrics_matches_jax(seed):
    gen, ref = _sets(seed)
    opts = dict(f1_threshold=THR, cd_option=True, f1_option=True)
    got = tev.compute_all_metrics(gen, ref, 60, device="cpu", **opts)
    want = jev.compute_all_metrics(gen, ref, 60, **opts)
    for metric in ("CD", "F1"):
        for key in ("lgan_mmd", "lgan_mmd_smp"):
            np.testing.assert_allclose(got[f"{key}-{metric}"],
                                       want[f"{key}-{metric}"], rtol=1e-5)
        assert got[f"lgan_cov-{metric}"] == want[f"lgan_cov-{metric}"]
        np.testing.assert_array_equal(got[f"idx_mmd-{metric}"],
                                      want[f"idx_mmd-{metric}"])
        for key in ("acc", "acc_t", "acc_f"):
            assert got[f"1-NN-{metric}-{key}"] == want[f"1-NN-{metric}-{key}"]


def test_paired_metrics_match_jax():
    gen, ref = _sets(2)
    opts = dict(cd_option=True, f1_option=True, one_part_of_cd=True,
                f1_threshold=THR)
    for reduced in (True, False):
        got = tev.EMD_CD_F1(gen, ref, 4, reduced=reduced, device="cpu",
                            **opts)
        want = jev.EMD_CD_F1(gen, ref, 4, reduced=reduced, **opts)
        for key in ("CD", "F1", "CDL", "CDR"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_ref_cache_reuses_and_guards():
    gen, ref = _sets(3)
    opts = dict(f1_threshold=THR, cd_option=True, f1_option=True)
    cache = {}
    first = tev.compute_all_metrics(gen, ref, 60, ref_cache=cache,
                                    device="cpu", **opts)
    assert len(cache) == 1
    again = tev.compute_all_metrics(gen, ref, 60, ref_cache=cache,
                                    device="cpu", **opts)
    assert again["1-NN-CD-acc"] == first["1-NN-CD-acc"]
    moved = tev.compute_all_metrics(gen, ref + 0.5, 60, ref_cache=cache,
                                    device="cpu", **opts)
    want = jev.compute_all_metrics(gen, ref + 0.5, 60, **opts)
    assert moved["1-NN-CD-acc"] == want["1-NN-CD-acc"]


@pytest.mark.parametrize("seed", [4, 5])
def test_compute_all_metrics_emd_matches_jax(seed):
    gen, ref = _sets(seed)
    opts = dict(f1_threshold=THR, cd_option=True, emd_option=True)
    got = tev.compute_all_metrics(gen, ref, 60, device="cpu", **opts)
    want = jev.compute_all_metrics(gen, ref, 60, **opts)
    for key in ("lgan_mmd", "lgan_mmd_smp"):
        np.testing.assert_allclose(got[f"{key}-EMD"], want[f"{key}-EMD"],
                                   rtol=1e-4)
    assert got["lgan_cov-EMD"] == want["lgan_cov-EMD"]
    np.testing.assert_array_equal(got["idx_mmd-EMD"], want["idx_mmd-EMD"])
    for key in ("acc", "acc_t", "acc_f"):
        assert got[f"1-NN-EMD-{key}"] == want[f"1-NN-EMD-{key}"]
    assert got["1-NN-CD-acc"] == want["1-NN-CD-acc"]


def test_paired_emd_matches_jax():
    gen, ref = _sets(6)
    for reduced in (True, False):
        got = tev.EMD_CD_F1(gen, ref, 4, reduced=reduced, emd_option=True,
                            cd_option=True, device="cpu")
        want = jev.EMD_CD_F1(gen, ref, 4, reduced=reduced, emd_option=True,
                             cd_option=True)
        np.testing.assert_allclose(got["EMD"], want["EMD"], rtol=1e-4)
        np.testing.assert_allclose(got["CD"], want["CD"], rtol=1e-5)
    assert tev.EMD_CD_F1(gen, ref, 4, cd_option=True,
                         device="cpu")["EMD"] == 0


def test_ref_cache_is_keyed_by_emd_option():
    """A cache filled by a CD-only call holds an all-zero EMD rr matrix;
    a later call with EMD must compute its own."""
    gen, ref = _sets(7)
    cache = {}
    tev.compute_all_metrics(gen, ref, 60, f1_threshold=THR, cd_option=True,
                            ref_cache=cache, device="cpu")
    opts = dict(f1_threshold=THR, cd_option=True, emd_option=True)
    got = tev.compute_all_metrics(gen, ref, 60, ref_cache=cache,
                                  device="cpu", **opts)
    assert len(cache) == 2
    want = jev.compute_all_metrics(gen, ref, 60, **opts)
    for key in ("acc", "acc_t", "acc_f"):
        assert got[f"1-NN-EMD-{key}"] == want[f"1-NN-EMD-{key}"]
    np.testing.assert_allclose(got["lgan_mmd-EMD"], want["lgan_mmd-EMD"],
                               rtol=1e-4)
    again = tev.compute_all_metrics(gen, ref, 60, ref_cache=cache,
                                    device="cpu", **opts)
    assert len(cache) == 2
    assert again["1-NN-EMD-acc"] == got["1-NN-EMD-acc"]


@pytest.mark.parametrize("entry", ["EMD_CD_F1", "pairwise_EMD_CD_F1",
                                   "compute_all_metrics"])
def test_metric_entry_points_default_to_the_card(entry):
    """The metrics run on the card unless the caller names the CPU (the
    tests above do)."""
    fn = getattr(tev, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _voxel_sets(seed):
    """Seeded clouds (S, N, 3) with points outside the [-0.5, 0.5) cube
    and a NaN."""
    rng = np.random.RandomState(seed)
    a = (rng.randn(5, 200, 3) * 0.3).astype(np.float32)
    b = (rng.randn(7, 150, 3) * 0.25).astype(np.float32)
    a[0, :3] = [0.7, -0.6, 0.55]
    a[1, 0, 2] = np.nan
    b[2, 5] = [0.5, 0.49, -0.5]  # on the cube's edges
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_occupancy_dist_matches_jax(seed, capsys):
    a, b = _voxel_sets(seed)
    for clouds in (a, b):
        got = tev.voxel_occupancy_dist(clouds)
        want = jev.voxel_occupancy_dist(clouds)
        assert got.shape == want.shape == (28, 28, 28)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert abs(got.sum() - 1.0) < 1e-12
    out = capsys.readouterr().out
    assert "out of cube bounds" in out and "1 NaN values" in out


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_jsd_matches_jax(seed):
    a, b = _voxel_sets(seed)
    got = tev.voxel_jsd(a, b, warn=False)
    want = jev.voxel_jsd(a, b, warn=False)
    assert abs(got - want) < 1e-12
    assert 0.0 < got < 1.0
    assert abs(tev.voxel_jsd(a, a, warn=False)) < 1e-12


def test_evaluate_jsd_matches_jax(capsys):
    """evaluate(util_mode="generating", jsd=True, cd=True) in the port
    and the JAX evaluate, each handed the same samples by its step: the
    same JSD (1e-12) and CD protocol (rtol 1e-5, COV and 1-NNA exact)."""
    rng = np.random.RandomState(3)
    B, N = 4, 64
    batches = [{"cloud": (rng.randn(B, 3, N) * 0.2).astype(np.float32),
                "eval_cloud": (rng.randn(B, 3, N) * 0.2).astype(np.float32)}
               for _ in range(2)]
    samples = [(rng.randn(B, 3, N) * 0.25).astype(np.float32)
               for _ in range(2)]
    labels = np.ones((B, N), np.int32)
    opts = dict(util_mode="generating", jsd=True, cd=True, f1=False,
                emd=False, f1_threshold_lst=[THR])

    replay = iter(samples)

    def t_step(g, generator):
        return torch.from_numpy(next(replay)), torch.from_numpy(labels), None

    got = t_evaluate(batches, t_step, torch.Generator().manual_seed(0),
                     "cpu", **opts)
    replay = iter(samples)

    def j_step(state, g, key):
        return jnp.asarray(next(replay)), jnp.asarray(labels), None

    want = j_evaluate(batches, j_step, None, jax.random.PRNGKey(0), **opts)
    capsys.readouterr()
    assert set(got) == set(want) == {"jsd", "cd_mmds", "cd_covs", "cd_1nns"}
    assert abs(got["jsd"] - want["jsd"]) < 1e-12
    assert 0.0 < got["jsd"] < 100.0
    np.testing.assert_allclose(got["cd_mmds"], want["cd_mmds"], rtol=1e-5)
    assert got["cd_covs"] == want["cd_covs"]
    assert got["cd_1nns"] == want["cd_1nns"]
