"""The port's pairwise Chamfer statistics (plain version, which the CPU
dispatch runs) against the JAX package's pairwise_cd_stats_pallas in
interpret mode, on a ragged grid.

Tolerances: cdl / cdr rtol 1e-5 (the same minima, summed in another
order); the counts behind precision / recall exact, with the threshold
set in the widest gap between the observed minima, away from every one
of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.ops.pallas.pairwise_kernel import (
    pairwise_cd_stats_pallas,
)
from go_with_the_flows_tpu_torch.ops.chamfer import pairwise_sqdists
from go_with_the_flows_tpu_torch.ops.kernels.pairwise import (
    pairwise_cd_stats,
)


def threshold_away_from(samples, refs):
    """The midpoint of the widest gap between the middle half of all row
    and column minima."""
    mins = []
    for s in samples:
        d = pairwise_sqdists(torch.from_numpy(s)[None].expand(len(refs), -1,
                                                              -1),
                             torch.from_numpy(refs))
        mins += [d.min(2).values.flatten(), d.min(1).values.flatten()]
    m = np.sort(torch.cat(mins).numpy())
    mid = m[len(m) // 4: 3 * len(m) // 4]
    gap = np.argmax(np.diff(mid))
    return float((mid[gap] + mid[gap + 1]) / 2)


@pytest.mark.parametrize("S,R,N,M", [(3, 4, 40, 53), (2, 2, 64, 17)])
def test_pairwise_cd_stats_matches_pallas(S, R, N, M):
    rng = np.random.RandomState(S + N)
    samples = rng.randn(S, N, 3).astype(np.float32) * 0.3
    refs = rng.randn(R, M, 3).astype(np.float32) * 0.3
    thr = threshold_away_from(samples, refs)
    got = pairwise_cd_stats(torch.from_numpy(samples), torch.from_numpy(refs),
                            thr)
    want = pairwise_cd_stats_pallas(jnp.asarray(samples), jnp.asarray(refs),
                                    thr, interpret=True)
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=0)
    # the point counts under the threshold are exact; the percentages
    # 100 * count / n may differ in the last bit (XLA multiplies by 1/n)
    for i, n in ((2, M), (3, N)):
        np.testing.assert_array_equal(np.rint(got[i].numpy() * n / 100),
                                      np.rint(np.asarray(want[i]) * n / 100))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=0)
    assert 0 < float(got[2].mean()) < 100  # the threshold splits the data
