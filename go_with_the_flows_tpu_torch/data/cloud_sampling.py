"""Mesh-surface point sampling on the host (counterpart of
go_with_the_flows_tpu/data/cloud_sampling.py).

Area-weighted triangle choice and uniform barycentric sampling with
fold-over reflection (the reference's `lib/datasets/cloud_sampling.py:
4-32`); with `return_eval_cloud`, 2N points are drawn and the even and
odd ones become `cloud` and `eval_cloud`. Clouds are (3, N) float32.

Meshes of more than 64 faces go through the native sampler
(`native.py`), seeded from `rng`; smaller ones, where the ctypes call
would cost more than the work, through numpy. That split is the JAX
package's, and the port keeps it so that both draw the same clouds.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import native

NATIVE_MIN_FACES = 65


def sample_cloud(vertices: np.ndarray, faces: np.ndarray, size: int = 2 ** 10,
                 return_eval_cloud: bool = False,
                 rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
    if rng is None:
        rng = np.random.default_rng()
    n = 2 * size if return_eval_cloud else size

    if len(faces) >= NATIVE_MIN_FACES:
        seed = int(rng.integers(0, 2 ** 62))
        pts = native.sample_cloud_native(vertices, faces, n, seed)
        if return_eval_cloud:
            return {"cloud": np.ascontiguousarray(pts[:, ::2]),
                    "eval_cloud": np.ascontiguousarray(pts[:, 1::2])}
        return {"cloud": pts}

    tri = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 2] - tri[:, 0], tri[:, 2] - tri[:, 1])
    areas = np.sqrt((cross ** 2).sum(1)) / 2.0
    total = areas.sum()
    if total <= 0:
        probs = np.full(len(areas), 1.0 / len(areas))
    else:
        probs = areas / total

    chosen = rng.choice(len(tri), size=n, p=probs)
    t = tri[chosen]  # (n, 3, 3)

    s1 = rng.random((n, 1), dtype=np.float32)
    s2 = rng.random((n, 1), dtype=np.float32)
    over = (s1 + s2) > 1.0
    s1[over] = 1.0 - s1[over]
    s2[over] = 1.0 - s2[over]

    pts = (t[:, 0] + s1 * (t[:, 1] - t[:, 0])
           + s2 * (t[:, 2] - t[:, 0])).astype(np.float32)

    if return_eval_cloud:
        return {"cloud": pts[::2].T, "eval_cloud": pts[1::2].copy().T}
    return {"cloud": pts.T}
