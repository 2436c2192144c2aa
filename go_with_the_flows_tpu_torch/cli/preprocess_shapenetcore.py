"""Offline preprocessing: ShapeNetCore.v2 OBJ files -> one packed-mesh
HDF5 file (the port's counterpart of the JAX package's root script
preprocess_shapenetcore.py, with its arguments and its output file):

    python -m go_with_the_flows_tpu_torch.cli.preprocess_shapenetcore \\
        DATA_DIR SAVE_DIR N_PROCESSES BATCH_SIZE

Reads the official DATA_DIR/all.csv split with the stdlib csv module,
maps the 55 synsets to labels 0..54 in sorted synset order, parses and
cleans every shapes/0<synset>/<model>/models/model_normalized.obj in a
multiprocessing pool (data/objmesh.py), and packs the ragged vertices
and faces with `*_bounds` prefix sums plus the orig/bbox scales of each
shape, part by part (train, val, test), into
SAVE_DIR/ShapeNetCore55v2_meshes.h5: dataset for dataset the JAX
script's file (names, dtypes, shapes, chunking and bytes). h5py is
imported only to write it. No card is used.
"""

from __future__ import annotations

import argparse
import csv
import multiprocessing
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.objmesh import ObjMesh

OUT_NAME = "ShapeNetCore55v2_meshes.h5"
PARTS = ("train", "val", "test")


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ShapeNetCore preprocessor: OBJ -> packed .h5.")
    p.add_argument("data_dir", type=str,
                   help="Unpacked dataset dir (with all.csv + shapes/).")
    p.add_argument("save_dir", type=str, help="Output dir.")
    p.add_argument("n_processes", type=int, help="Parallel workers.")
    p.add_argument("batch_size", type=int, help="Shapes per batch.")
    return p


def process_obj_file(path: str) -> Dict[str, np.ndarray]:
    """One OBJ parsed, cleaned and reformatted (a pool worker's task)."""
    mesh = ObjMesh(path)
    mesh.cleanup()
    return mesh.reformat()


def read_split(path: str) -> List[Dict[str, str]]:
    """The rows of all.csv. The synset ids are numbers, as pandas reads
    them in the JAX script: "02691156" and "2691156" are one synset."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        row["synsetId"] = int(row["synsetId"])
    return rows


def category_labels(rows: Sequence[Dict]) -> Dict[str, int]:
    """"0<synset>" -> label, in sorted synset order."""
    return {"0{}".format(cat): i for i, cat in
            enumerate(sorted({row["synsetId"] for row in rows}))}


def collect_samples(data_dir: str, rows: Sequence[Dict], part: str,
                    cat2label: Dict[str, int]):
    """The OBJ paths and labels of a part, in all.csv's order, skipping
    missing shapes."""
    samples, labels = [], []
    for row in rows:
        if row["split"] != part:
            continue
        name = "0{}/{}/models/".format(row["synsetId"], row["modelId"])
        obj = os.path.join(data_dir, "shapes", name, "model_normalized.obj")
        if os.path.exists(obj):
            samples.append(obj)
            labels.append(cat2label["0{}".format(row["synsetId"])])
        else:
            print(f"{name} missing, skipping this shape.")
    return samples, labels


def create_mesh_datasets(fout, part: str, n: int, labels: Sequence[int]):
    """The part's datasets in the JAX scripts' layout: bounds (n + 1,)
    uint64, vertices and faces (0, 3) resizable along the first axis,
    orig/bbox scales, labels uint8. Returns (vertex bounds, face bounds,
    vertices, faces, orig_c, orig_s, bbox_c, bbox_s)."""
    vcb = fout.create_dataset(f"{part}_vertices_c_bounds", (n + 1,),
                              dtype=np.uint64)
    fb = fout.create_dataset(f"{part}_faces_bounds", (n + 1,),
                             dtype=np.uint64)
    vc = fout.create_dataset(f"{part}_vertices_c", (0, 3),
                             maxshape=(None, 3), dtype=np.float32)
    fvc = fout.create_dataset(f"{part}_faces_vc", (0, 3),
                              maxshape=(None, 3), dtype=np.uint32)
    orig_c = fout.create_dataset(f"{part}_orig_c", (n, 3), dtype=np.float32)
    orig_s = fout.create_dataset(f"{part}_orig_s", (n,), dtype=np.float32)
    bbox_c = fout.create_dataset(f"{part}_bbox_c", (n, 3), dtype=np.float32)
    bbox_s = fout.create_dataset(f"{part}_bbox_s", (n,), dtype=np.float32)
    fout.create_dataset(f"{part}_labels",
                        data=np.asarray(labels, np.uint8))
    vcb[0] = 0
    fb[0] = 0
    return vcb, fb, vc, fvc, orig_c, orig_s, bbox_c, bbox_s


def write_meshes(paths: Sequence[str], datasets, n_processes: int,
                 batch_size: int, progress: str):
    """Clean the OBJs at `paths` in a pool of n_processes, batch_size at a
    time, and append each to the part's datasets, in order."""
    vcb, fb, vc, fvc, orig_c, orig_s, bbox_c, bbox_s = datasets
    n = len(paths)
    done = 0
    with multiprocessing.Pool(processes=n_processes) as pool:
        for start in range(0, n, batch_size):
            for data in pool.map(process_obj_file,
                                 paths[start:start + batch_size]):
                i = done
                nv, nf = len(data["vertices_c"]), len(data["faces_vc"])
                vc.resize(vc.shape[0] + nv, axis=0)
                vc[-nv:] = data["vertices_c"]
                fvc.resize(fvc.shape[0] + nf, axis=0)
                fvc[-nf:] = data["faces_vc"]
                vcb[i + 1] = vcb[i] + nv
                fb[i + 1] = fb[i] + nf
                orig_c[i], orig_s[i] = data["orig_c"], data["orig_s"]
                bbox_c[i], bbox_s[i] = data["bbox_c"], data["bbox_s"]
                done += 1
            print(progress.format(done=done, n=n))


def preprocess(data_dir: str, save_dir: str, n_processes: int,
               batch_size: int) -> str:
    """Write save_dir/ShapeNetCore55v2_meshes.h5 from data_dir; returns
    its path."""
    import h5py

    rows = read_split(os.path.join(data_dir, "all.csv"))
    cat2label = category_labels(rows)
    os.makedirs(save_dir, exist_ok=True)
    out_path = os.path.join(save_dir, OUT_NAME)
    with h5py.File(out_path, "w") as fout:
        for part in PARTS:
            samples, labels = collect_samples(data_dir, rows, part,
                                              cat2label)
            print(f"{part}: {len(samples)} shapes")
            datasets = create_mesh_datasets(fout, part, len(samples),
                                            labels)
            write_meshes(samples, datasets, n_processes, batch_size,
                         part + ": {done}/{n}")
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = define_options_parser().parse_args(argv)
    return preprocess(args.data_dir, args.save_dir, args.n_processes,
                      args.batch_size)


if __name__ == "__main__":
    main()
