"""Synthetic data in the layout of the ShapeNet h5 files (counterpart of
go_with_the_flows_tpu/data/synthetic.py), for the CPU tests and for
chip_smoke.py, which runs the datasets without h5py.

`synthetic_meshes` and `synthetic_images` return the layout as a dict of
numpy arrays (the datasets' `store`); `write_synthetic_meshes_h5` and
`write_synthetic_images_h5` write the same arrays into h5 files (h5py is
imported only there). With the defaults (jittered 12-triangle cubes) the
arrays equal the JAX package's writers' for the same seed.
`sphere_level=L` gives closed meshes of 20 x 4^L triangles instead, as
many as ShapeNet meshes have (L=4: 5,120 faces, 2,562 vertices):
jittered ellipsoids, so that sampling a cloud costs the host what a real
mesh costs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np


def _unit_cube_mesh(rng, scale=0.5, jitter=0.05):
    """A jittered cube: 8 vertices, 12 triangles."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * scale
    v = v + rng.normal(scale=jitter, size=v.shape).astype(np.float32)
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # x-
            [4, 6, 7], [4, 7, 5],  # x+
            [0, 4, 5], [0, 5, 1],  # y-
            [2, 3, 7], [2, 7, 6],  # y+
            [0, 2, 6], [0, 6, 4],  # z-
            [1, 5, 7], [1, 7, 3],  # z+
        ],
        np.uint32,
    )
    return v, f


def icosphere(level: int):
    """Unit sphere mesh: an icosahedron with each triangle split into four
    `level` times. (vertices (V, 3) float64, faces (20 * 4^level, 3))."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(level):
        midpoints = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in midpoints:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                midpoints[key] = len(verts) - 1
            return midpoints[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return np.stack(verts), np.asarray(faces, np.uint32)


def _ellipsoid_mesh(rng, sphere, jitter=0.02):
    """A closed ellipsoid of semi-axes in [0.2, 0.5], each vertex moved
    along its ray by a relative N(0, jitter)."""
    v, f = sphere
    axes = rng.uniform(0.2, 0.5, size=3)
    radial = 1.0 + rng.normal(scale=jitter, size=(len(v), 1))
    return (v * axes * radial).astype(np.float32), f


def synthetic_meshes(
    n_shapes: Union[int, Dict[str, int]] = 8,
    parts: Sequence[str] = ("train", "val", "test"),
    n_categories: int = 55,
    labels=None,
    seed: int = 0,
    sphere_level: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Packed meshes in the reference's ragged layout
    (preprocess_ShapeNetCore.py:81-133): per part, `<part>_vertices_c` and
    `<part>_faces_vc` concatenated with `*_bounds` prefix sums, labels
    (random, or `labels`: one per shape or one for all) and original and
    bounding-box scales. `n_shapes` is a count for every part or a count
    per part."""
    rng = np.random.default_rng(seed)
    sphere = icosphere(sphere_level) if sphere_level is not None else None
    out = {}
    for part in parts:
        n = n_shapes[part] if isinstance(n_shapes, dict) else n_shapes
        verts, faces = [], []
        v_bounds, f_bounds = [0], [0]
        for _ in range(n):
            v, fc = (_unit_cube_mesh(rng) if sphere is None
                     else _ellipsoid_mesh(rng, sphere))
            verts.append(v)
            faces.append(fc)
            v_bounds.append(v_bounds[-1] + len(v))
            f_bounds.append(f_bounds[-1] + len(fc))
        out[part + "_vertices_c"] = np.concatenate(verts)
        out[part + "_faces_vc"] = np.concatenate(faces)
        out[part + "_vertices_c_bounds"] = np.asarray(v_bounds, np.uint64)
        out[part + "_faces_bounds"] = np.asarray(f_bounds, np.uint64)
        if labels is None:
            part_labels = rng.integers(0, n_categories, size=n).astype(
                np.uint8)
        else:
            part_labels = np.broadcast_to(np.asarray(labels, np.uint8),
                                          (n,)).copy()
        out[part + "_labels"] = part_labels
        out[part + "_orig_c"] = (rng.normal(size=(n, 3)).astype(np.float32)
                                 * 0.01)
        out[part + "_orig_s"] = np.ones((n,), np.float32)
        out[part + "_bbox_c"] = np.zeros((n, 3), np.float32)
        out[part + "_bbox_s"] = np.ones((n,), np.float32)
    return out


def synthetic_images(
    n_shapes: Union[int, Dict[str, int]] = 8,
    parts: Sequence[str] = ("train", "test"),
    views: int = 24,
    hw: int = 137,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Renderings in the reference layout (preprocess_ShapeNetAll.py:
    65-78): `<part>_images`, (views * n_shapes, 4, hw, hw) uint8 RGBA
    noise."""
    rng = np.random.default_rng(seed)
    out = {}
    for part in parts:
        n = n_shapes[part] if isinstance(n_shapes, dict) else n_shapes
        out[part + "_images"] = rng.integers(
            0, 256, size=(views * n, 4, hw, hw)).astype(np.uint8)
    return out


def _write_h5(path: str, arrays: Dict[str, np.ndarray]) -> str:
    import h5py

    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=value)
    return path


def write_synthetic_meshes_h5(path: str, **kwargs) -> str:
    """`synthetic_meshes(**kwargs)` written into an h5 file at `path`."""
    return _write_h5(path, synthetic_meshes(**kwargs))


def write_synthetic_images_h5(path: str, **kwargs) -> str:
    """`synthetic_images(**kwargs)` written into an h5 file at `path`."""
    return _write_h5(path, synthetic_images(**kwargs))
