"""Offline preprocessing for SVR: the ShapeNetAll13 (3D-R2N2) renderings
and ShapeNetCore.v1 meshes -> ShapeNetAll13_images.h5 and
ShapeNetAll13_meshes.h5 (the port's counterpart of the JAX package's root
script preprocess_shapenetall.py, with its arguments and its files):

    python -m go_with_the_flows_tpu_torch.cli.preprocess_shapenetall \\
        SNA_DATA_DIR SNC1_DATA_DIR SAVE_DIR N_PROCESSES BATCH_SIZE \\
        [--skip_copy]

Unless --skip_copy, each rendered shape's mesh directory is first copied
from SNC1_DATA_DIR/<synset>/<model> to SNA_DATA_DIR/ShapeNetMesh/
(where it is not there yet). Per category (sorted ShapeNetMesh
synsets), the first 80 % of the sorted model names are train, the rest
test; each shape's 24 renderings
(ShapeNetRendering/<synset>/<model>/rendering/00.png .. 23.png, 137 x 137
RGBA) are packed as (24 S, 4, 137, 137) uint8 by the port's own PNG
reader (data/png.py; the JAX script uses cv2), and its model.obj is
cleaned (data/objmesh.py) and packed as preprocess_shapenetcore packs
ShapeNetCore. The files are, dataset for dataset, the JAX script's.
h5py is imported only to write them. No card is used.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from itertools import product
from typing import Optional, Sequence

import numpy as np

from ..data.png import read_png
from .preprocess_shapenetcore import create_mesh_datasets, write_meshes

IMAGES_NAME = "ShapeNetAll13_images.h5"
MESHES_NAME = "ShapeNetAll13_meshes.h5"
VIEWS = 24


def define_options_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ShapeNetAll13 preprocessor.")
    p.add_argument("sna_data_dir", type=str,
                   help="Dir with ShapeNetRendering/ (and ShapeNetMesh/).")
    p.add_argument("snc1_data_dir", type=str,
                   help="ShapeNetCore.v1 root (meshes are copied from it).")
    p.add_argument("save_dir", type=str)
    p.add_argument("n_processes", type=int)
    p.add_argument("batch_size", type=int)
    p.add_argument("--skip_copy", action="store_true",
                   help="Skip the ShapeNetCore.v1 -> ShapeNetMesh copy.")
    return p


def part_samples(sna_data_dir: str, cats: Sequence[str], part: str):
    """The (synset, model) pairs of a part and their labels: per
    category the first 80 % of the sorted model directories are train,
    the rest test."""
    samples, labels = [], []
    cat2label = {cat: i for i, cat in enumerate(cats)}
    for cat in cats:
        root = os.path.join(sna_data_dir, "ShapeNetMesh", cat)
        names = sorted(
            n for n in os.listdir(root)
            if os.path.isdir(os.path.join(root, n))
        )
        cut = int(0.8 * len(names))
        names = names[:cut] if part == "train" else names[cut:]
        samples += [(cat, n) for n in names]
        labels += len(names) * [cat2label[cat]]
    return samples, labels


def copy_meshes(sna_data_dir: str, snc1_data_dir: str):
    """Copy each rendered shape's ShapeNetCore.v1 directory into
    ShapeNetMesh/, where it is not there yet."""
    render_root = os.path.join(sna_data_dir, "ShapeNetRendering")
    for cat in sorted(os.listdir(render_root)):
        for sample in sorted(os.listdir(os.path.join(render_root, cat))):
            dst = os.path.join(sna_data_dir, "ShapeNetMesh", cat, sample)
            if not os.path.exists(dst):
                shutil.copytree(os.path.join(snc1_data_dir, cat, sample),
                                dst)


def process_images(part: str, cats: Sequence[str], fout, sna_data_dir: str,
                   n_processes: int, batch_size: int):
    """The part's renderings, (24 S, 4, 137, 137) uint8, and labels."""
    samples, labels = part_samples(sna_data_dir, cats, part)
    n = len(samples)
    images = fout.create_dataset(
        f"{part}_images", shape=(VIEWS * n, 4, 137, 137), dtype=np.uint8)
    fout.create_dataset(f"{part}_labels",
                        data=np.asarray(labels, np.uint8))
    bs = max(batch_size // VIEWS, 1)
    with multiprocessing.Pool(n_processes) as pool:
        for start in range(0, n, bs):
            chunk = samples[start:start + bs]
            paths = [
                os.path.join(sna_data_dir, "ShapeNetRendering", cat, name,
                             "rendering", f"{v:02d}.png")
                for (cat, name), v in product(chunk, range(VIEWS))
            ]
            results = pool.map(read_png, paths)
            images[VIEWS * start:VIEWS * (start + len(chunk))] = (
                np.concatenate(results, 0))
            print(f"Packing {part} images: [{start + len(chunk)}/{n}]")


def process_meshes(part: str, cats: Sequence[str], fout, sna_data_dir: str,
                   n_processes: int, batch_size: int):
    """The part's cleaned meshes in the packed layout."""
    samples, labels = part_samples(sna_data_dir, cats, part)
    paths = [os.path.join(sna_data_dir, "ShapeNetMesh", cat, name,
                          "model.obj") for cat, name in samples]
    datasets = create_mesh_datasets(fout, part, len(paths), labels)
    write_meshes(paths, datasets, n_processes, batch_size,
                 "Packing " + part + " meshes: [{done}/{n}]")


def preprocess(sna_data_dir: str, snc1_data_dir: str, save_dir: str,
               n_processes: int, batch_size: int, skip_copy: bool = False):
    """Write save_dir's two h5 files; returns their paths (images,
    meshes)."""
    import h5py

    if not skip_copy:
        copy_meshes(sna_data_dir, snc1_data_dir)
    cats = sorted(os.listdir(os.path.join(sna_data_dir, "ShapeNetMesh")))
    os.makedirs(save_dir, exist_ok=True)
    paths = (os.path.join(save_dir, IMAGES_NAME),
             os.path.join(save_dir, MESHES_NAME))
    for path, process in zip(paths, (process_images, process_meshes)):
        with h5py.File(path, "w") as f:
            for part in ("train", "test"):
                process(part, cats, f, sna_data_dir, n_processes,
                        batch_size)
    return paths


def main(argv: Optional[Sequence[str]] = None):
    args = define_options_parser().parse_args(argv)
    return preprocess(args.sna_data_dir, args.snc1_data_dir, args.save_dir,
                      args.n_processes, args.batch_size, args.skip_copy)


if __name__ == "__main__":
    main()
