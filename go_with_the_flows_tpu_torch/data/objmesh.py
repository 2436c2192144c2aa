"""OBJ mesh ingestion and cleanup for the offline preprocessing (the
port's own copy of go_with_the_flows_tpu/data/objmesh.py, host side,
numpy; the duplicate-vertex merge finds its pairs with scipy's cKDTree,
imported only there, as the JAX package's module does, so that the two
merge the same pairs in the same order and write the same bytes).

Behaviour port of the reference's `lib/meshes/objmesh.py:8-264`:

  parse    - v / g / o / f / l records, groups with duplicate-name
             suffixing, 1-based index shift;
  cleanup  - drop empty groups; drop isolated vertices; merge duplicate
             vertices (euclidean tolerance 5e-6); drop non-triangular
             faces (fewer than 3 distinct vertex ids); drop zero-area
             (atol 1e-10) and collinear (|cos| ~ 1, rtol 1e-5) faces;
             drop duplicate faces per group and globally (keeping the
             LAST occurrence of each vertex set, matching the reference's
             OrderedDict construction); recenter to the area-weighted
             surface centroid and rescale to the unit sphere, recording
             orig_c / orig_s;
  reformat - emit {vertices_c, faces_vc, orig_c, orig_s, bbox_c, bbox_s}
             (objmesh.py:248-264).

The reference's cleanup is O(V^2) Python loops; this one is vectorized
numpy.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List

import numpy as np


def _dedup_keep_last(faces: np.ndarray) -> np.ndarray:
    """Boolean mask keeping the LAST occurrence of each unordered vertex
    triple (the reference's frozenset-keyed OrderedDict semantics)."""
    if len(faces) == 0:
        return np.zeros(0, bool)
    keys = np.sort(faces, axis=1)
    seen = {}
    for i, k in enumerate(map(tuple, keys)):
        seen[k] = i
    keep = np.zeros(len(faces), bool)
    keep[list(seen.values())] = True
    return keep


class ObjMesh:
    def __init__(self, filename: str):
        self.obj_filename = filename
        self.vertices = np.zeros((0, 3), np.float32)
        self.groups: "OrderedDict[str, Dict[str, List]]" = OrderedDict()
        self.vertices_center = np.zeros(3, np.float32)
        self.vertices_scale = 1.0
        self._parse(filename)

    # ------------------------------------------------------------------ #

    def _new_group(self, base: str):
        i = 0
        name = f"{base}_{i}"
        while name in self.groups:
            i += 1
            name = f"{base}_{i}"
        self.groups[name] = {"faces_v": [], "lines": []}
        return name

    def _parse(self, filename: str):
        verts: List[List[float]] = []
        cur_group = None
        with open(filename, "r") as f:
            for raw in f:
                line = re.sub(" +", " ", raw.strip())
                if not line or line[0] == "#":
                    continue
                segs = line.split()
                tag = segs[0]
                if tag == "v":
                    verts.append([float(x) for x in segs[1:4]])
                elif tag in ("g", "o"):
                    cur_group = self._new_group(segs[-1])
                elif tag == "f":
                    if cur_group is None:
                        cur_group = self._new_group("initg")
                    ids = [int(s.split("/")[0]) for s in segs[1:]]
                    self.groups[cur_group]["faces_v"].append(ids[:3])
                elif tag == "l":
                    if cur_group is None:
                        cur_group = self._new_group("initg")
                    self.groups[cur_group]["lines"].append(
                        [int(s) for s in segs[1:3]]
                    )
        self.vertices = np.asarray(verts, np.float32).reshape(-1, 3)
        for g in self.groups.values():
            g["faces_v"] = (
                np.asarray(g["faces_v"], np.int64).reshape(-1, 3) - 1
            )
            g["lines"] = (
                np.asarray(g["lines"], np.int64).reshape(-1, 2) - 1
            )

    # ------------------------------------------------------------------ #

    def _drop_empty_groups(self):
        for key in [k for k, g in self.groups.items()
                    if len(g["faces_v"]) == 0]:
            del self.groups[key]

    def _compact_vertices(self):
        """Drop vertices not referenced by any face and reindex."""
        used = np.zeros(len(self.vertices), bool)
        for g in self.groups.values():
            used[np.unique(g["faces_v"])] = True
        if used.all():
            return
        new_ids = np.cumsum(used) - 1
        self.vertices = self.vertices[used]
        for g in self.groups.values():
            g["faces_v"] = new_ids[g["faces_v"]]

    def _merge_duplicate_vertices(self, atol=5e-6):
        """Map each vertex to the first earlier vertex within atol."""
        v = self.vertices
        n = len(v)
        canonical = np.arange(n)
        from scipy.spatial import cKDTree

        tree = cKDTree(v)
        pairs = tree.query_pairs(atol, output_type="ndarray")
        if len(pairs) == 0:
            return
        # union toward the smaller index (reference maps dup -> first)
        for a, b in pairs[np.argsort(pairs[:, 1])]:
            lo, hi = (a, b) if a < b else (b, a)
            root = lo
            while canonical[root] != root:
                root = canonical[root]
            canonical[hi] = root
        for i in range(n):
            r = i
            while canonical[r] != r:
                r = canonical[r]
            canonical[i] = r
        keep = canonical == np.arange(n)
        new_ids = np.cumsum(keep) - 1
        remap = new_ids[canonical]
        self.vertices = self.vertices[keep]
        for g in self.groups.values():
            g["faces_v"] = remap[g["faces_v"]]

    def cleanup(self):
        self._drop_empty_groups()
        self._compact_vertices()
        self._merge_duplicate_vertices()

        for g in self.groups.values():
            f = g["faces_v"]
            # non-triangular: fewer than 3 distinct vertices
            distinct = (
                (f[:, 0] != f[:, 1])
                & (f[:, 0] != f[:, 2])
                & (f[:, 1] != f[:, 2])
            )
            f = f[distinct]
            if len(f):
                ps = self.vertices[f]
                areas = np.sqrt(
                    (np.cross(ps[:, 2] - ps[:, 0],
                              ps[:, 1] - ps[:, 0]) ** 2).sum(1)
                ) / 2.0
                f = f[~np.isclose(areas, 0.0, atol=1e-10)]
            if len(f):
                ps = self.vertices[f]
                e1 = ps[:, 1] - ps[:, 0]
                e1 /= np.sqrt((e1 ** 2).sum(1, keepdims=True))
                e2 = ps[:, 2] - ps[:, 0]
                e2 /= np.sqrt((e2 ** 2).sum(1, keepdims=True))
                cos = np.fabs((e1 * e2).sum(1))
                f = f[~np.isclose(cos, 1.0, rtol=1e-5)]
            g["faces_v"] = f[_dedup_keep_last(f)] if len(f) else f

        # global duplicate faces (keep last across groups)
        all_faces = np.concatenate(
            [g["faces_v"] for g in self.groups.values()]
        ) if self.groups else np.zeros((0, 3), np.int64)
        keep_global = _dedup_keep_last(all_faces)
        pos = 0
        for g in self.groups.values():
            n = len(g["faces_v"])
            g["faces_v"] = g["faces_v"][keep_global[pos:pos + n]]
            pos += n

        self._drop_empty_groups()
        self._compact_vertices()

        # recenter to area-weighted surface centroid, rescale to unit
        # sphere (objmesh.py:231-246)
        all_faces = np.concatenate(
            [g["faces_v"] for g in self.groups.values()]
        )
        polygons = self.vertices[all_faces]
        centers = polygons.mean(1)
        areas = np.sqrt(
            (np.cross(polygons[:, 2] - polygons[:, 0],
                      polygons[:, 2] - polygons[:, 1]) ** 2).sum(1)
        ) / 2.0
        weights = areas / areas.sum()
        shape_center = (weights[:, None] * centers).sum(0)
        self.vertices = self.vertices - shape_center[None]
        shape_scale = np.sqrt((self.vertices ** 2).sum(1)).max()
        self.vertices = self.vertices / shape_scale
        self.vertices_scale = shape_scale
        self.vertices_center = shape_center

    def reformat(self):
        faces_v = np.concatenate(
            [g["faces_v"] for g in self.groups.values()]
        ).astype(np.uint32)
        mins, maxs = self.vertices.min(0), self.vertices.max(0)
        return {
            "vertices_c": self.vertices.astype(np.float32),
            "orig_c": self.vertices_center.astype(np.float32),
            "orig_s": np.float32(self.vertices_scale),
            "bbox_c": ((maxs + mins) / 2.0).astype(np.float32),
            "bbox_s": np.float32((maxs - mins).max()),
            "faces_vc": faces_v,
        }
