"""Seeded per-category reshuffle of the train/val/test splits of a packed
ShapeNetCore file (the port's counterpart of the JAX package's root
script resample_shapenetcore.py, with its argument and its output):

    python -m go_with_the_flows_tpu_torch.cli.resample_shapenetcore \\
        DATA_PATH

For each of the 55 categories it pools the category's shapes over the
three parts, shuffles them with numpy's RandomState(1) (one stream over
all categories, as the JAX script's np.random.seed(1)), and deals them
back out in the original part sizes. Writes <DATA_PATH minus .h5>
_resampled.h5 in the same ragged layout, dataset for dataset the JAX
script's file. h5py is imported only here. No card is used.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

PARTS = ("train", "val", "test")
N_CATEGORIES = 55


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Resample ShapeNetCore splits.")
    p.add_argument("data_path", type=str, help="Packed meshes .h5 path.")
    return p


def assign(labels: Dict[str, np.ndarray], seed: int = 1):
    """part -> [(source part, source index)] of the shapes it receives."""
    rng = np.random.RandomState(seed)
    assignments = {p: [] for p in PARTS}
    for c in range(N_CATEGORIES):
        pool, sizes = [], {}
        for p in PARTS:
            inds = (labels[p] == c).nonzero()[0]
            sizes[p] = len(inds)
            pool += [(p, int(i)) for i in inds]
        order = np.arange(len(pool))
        rng.shuffle(order)
        shuffled = [pool[j] for j in order]
        n_train, n_val = sizes["train"], sizes["val"]
        assignments["train"] += shuffled[:n_train]
        assignments["val"] += shuffled[n_train:n_train + n_val]
        assignments["test"] += shuffled[n_train + n_val:]
    return assignments


def _copy_shape(fin, fout, src_part, src_i, dst_part, dst_i, bounds_state):
    """Append shape src_i of src_part to dst_part of fout."""
    vb = np.asarray(fin[f"{src_part}_vertices_c_bounds"])
    fb = np.asarray(fin[f"{src_part}_faces_bounds"])
    verts = fin[f"{src_part}_vertices_c"][vb[src_i]:vb[src_i + 1]]
    faces = fin[f"{src_part}_faces_vc"][fb[src_i]:fb[src_i + 1]]

    vc = fout[f"{dst_part}_vertices_c"]
    fvc = fout[f"{dst_part}_faces_vc"]
    vc.resize(vc.shape[0] + len(verts), axis=0)
    vc[-len(verts):] = verts
    fvc.resize(fvc.shape[0] + len(faces), axis=0)
    fvc[-len(faces):] = faces

    state = bounds_state[dst_part]
    fout[f"{dst_part}_vertices_c_bounds"][dst_i + 1] = state["v"] + len(verts)
    fout[f"{dst_part}_faces_bounds"][dst_i + 1] = state["f"] + len(faces)
    state["v"] += len(verts)
    state["f"] += len(faces)

    for key in ("orig_c", "orig_s", "bbox_c", "bbox_s", "labels"):
        src = f"{src_part}_{key}"
        if src in fin:
            fout[f"{dst_part}_{key}"][dst_i] = fin[src][src_i]


def resample(data_path: str) -> str:
    """Write data_path's resampled file; returns its path."""
    import h5py

    out_path = data_path[:-3] + "_resampled.h5"
    with h5py.File(data_path, "r") as fin, h5py.File(out_path, "w") as fout:
        assignments = assign({p: np.asarray(fin[f"{p}_labels"])
                              for p in PARTS})
        for key in fin.keys():
            if any(s in key for s in ("bounds", "labels", "orig", "bbox")):
                fout.create_dataset(key, shape=fin[key].shape,
                                    dtype=fin[key].dtype)
            else:
                fout.create_dataset(
                    key, shape=(0,) + fin[key].shape[1:],
                    maxshape=(None,) + fin[key].shape[1:],
                    dtype=fin[key].dtype)
        bounds_state = {p: {"v": 0, "f": 0} for p in PARTS}
        for p in PARTS:
            fout[f"{p}_vertices_c_bounds"][0] = 0
            fout[f"{p}_faces_bounds"][0] = 0
            for dst_i, (src_part, src_i) in enumerate(assignments[p]):
                _copy_shape(fin, fout, src_part, src_i, p, dst_i,
                            bounds_state)
            print(f"{p}: {len(assignments[p])} shapes")
    print("wrote", out_path)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = define_options_parser().parse_args(argv)
    return resample(args.data_path)


if __name__ == "__main__":
    main()
