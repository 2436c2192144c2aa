"""The port's metrics against the JAX package's, 6 vs 6 clouds on the
CPU (both sides in fp32 from the same numpy clouds).

Tolerances: MMD and CD rtol 1e-5 (the same per-pair minima, averaged in
another order); MMD-EMD and paired EMD rtol 1e-4 (the auction's sums run
in another order, the bound of tests/test_pallas_kernels.py); COV and
1-NNA exact (argmins and nearest neighbours of matrices that agree to
1e-4 on these sets).
"""

import inspect

import numpy as np
import pytest

from go_with_the_flows_tpu.metrics import evaluation as jev
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
