"""ShapeNet datasets on the host (counterpart of
go_with_the_flows_tpu/data/datasets.py).

Behaviour port of the reference's `lib/datasets/datasets.py`:

  * ShapeNetCoreDataset: meshes packed in ragged arrays addressed by
    `*_bounds` prefix sums; each item samples a fresh `cloud` (and
    `eval_cloud`) from its mesh's surface; optional original and
    bounding-box scales, one-hot labels and a `chosen_label` category
    filter.
  * ShapeNetAllDataset: adds 24 renderings a shape; its length is 24 x
    the shapes, item i is view i of shape i // 24.

Storage: a mapping with the h5 files' keys (`<part>_vertices_c`,
`<part>_vertices_c_bounds`, `<part>_faces_vc`, `<part>_faces_bounds`,
`<part>_labels`, `<part>_orig_c` / `_orig_s`, `<part>_bbox_c` /
`_bbox_s`, and `<part>_images` for ShapeNetAll). By default the
datasets open `path2data/meshes_fname` (and `images_fname`) with h5py,
which is imported only then; a caller may instead hand in `store`, a
dict of numpy arrays with the same keys (data/synthetic.py makes one).

Random draws: item i of epoch e takes a Generator seeded with
(base_seed, e, i). `__getitem__` seeds from the index it was given,
before `chosen_label` maps it; `get_batch` seeds the whole batch from
its first index after the mapping (for ShapeNetAll, from the first
view's image index). Both are the JAX package's rules, which parity
depends on.
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional

import numpy as np

from . import native
from .cloud_sampling import sample_cloud


def _open_h5(path: str):
    import h5py

    return h5py.File(path, "r", libver="latest", swmr=True)


class ShapeNetCoreDataset:
    N_CATEGORIES = 55

    def __init__(
        self,
        path2data: Optional[str] = None,
        part: str = "train",
        meshes_fname: str = "meshes.h5",
        cloud_size: int = 2 ** 10,
        return_eval_cloud: bool = False,
        return_original_scale: bool = False,
        return_bbox_scale: bool = False,
        cloud_transform=None,
        sample_labels: bool = False,
        chosen_label: Optional[int] = None,
        base_seed: int = 0,
        store: Optional[Mapping] = None,
    ):
        if store is None and path2data is None:
            raise ValueError("give path2data (h5 files) or store (arrays)")
        self.path2data = path2data
        self.meshes_fname = meshes_fname
        self.cloud_size = cloud_size
        self.return_eval_cloud = return_eval_cloud
        self.return_original_scale = return_original_scale
        self.return_bbox_scale = return_bbox_scale
        self.cloud_transform = cloud_transform
        self.sample_labels = sample_labels
        self.chosen_label = chosen_label
        self.base_seed = base_seed
        self.store = store
        self.epoch = 0
        self.data_file = None
        self.choose_part(part)

    def _meshes_path(self) -> str:
        return os.path.join(self.path2data, self.meshes_fname)

    def _meshes(self) -> Mapping:
        if self.store is not None:
            return self.store
        if self.data_file is None:
            self.data_file = _open_h5(self._meshes_path())
        return self.data_file

    def choose_part(self, part: str):
        self.part = part
        with (contextlib.nullcontext(self.store) if self.store is not None
              else _open_h5(self._meshes_path())) as fin:
            if self.sample_labels:
                raw = np.asarray(fin[part + "_labels"])
                self.labels = np.zeros((raw.shape[0], self.N_CATEGORIES),
                                       np.float32)
                self.labels[np.arange(raw.shape[0]), raw] = 1.0
            self.vertices_c_bounds = np.asarray(
                fin[part + "_vertices_c_bounds"], np.uint64)
            self.faces_bounds = np.asarray(fin[part + "_faces_bounds"],
                                           np.uint64)
            if self.return_original_scale:
                self.original_centers = np.asarray(fin[part + "_orig_c"],
                                                   np.float32)
                self.original_scales = np.asarray(fin[part + "_orig_s"],
                                                  np.float32)
            if self.return_bbox_scale:
                self.bbox_centers = np.asarray(fin[part + "_bbox_c"],
                                               np.float32)
                self.bbox_scales = np.asarray(fin[part + "_bbox_s"],
                                              np.float32)
            if self.chosen_label is not None:
                self.chosen_label_inds = (
                    np.asarray(fin[part + "_labels"], np.uint8)
                    == self.chosen_label).nonzero()[0]

    def close(self):
        if self.data_file is not None:
            self.data_file.close()
            self.data_file = None

    def __getstate__(self):
        """Picklable for spawned loader workers: an open h5 handle cannot
        cross a process boundary, so it is dropped and each worker opens
        its own at its first read."""
        state = self.__dict__.copy()
        for key in ("data_file", "images_file"):
            if key in state:
                state[key] = None
        return state

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def n_shapes(self) -> int:
        if self.chosen_label is not None:
            return self.chosen_label_inds.shape[0]
        return self.vertices_c_bounds.shape[0] - 1

    def __len__(self):
        return self.n_shapes()

    def _rng(self, i) -> np.random.Generator:
        return np.random.default_rng((self.base_seed, self.epoch, int(i)))

    def _read_mesh(self, i):
        f = self._meshes()
        vb, fb = self.vertices_c_bounds, self.faces_bounds
        vertices = np.asarray(
            f[self.part + "_vertices_c"][vb[i]:vb[i + 1]], np.float32)
        faces = np.asarray(f[self.part + "_faces_vc"][fb[i]:fb[i + 1]],
                           np.uint32)
        return vertices, faces

    def _split(self, pts) -> dict:
        """A sample dict from (3, n) drawn points."""
        if self.return_eval_cloud:
            return {"cloud": np.ascontiguousarray(pts[:, ::2]),
                    "eval_cloud": np.ascontiguousarray(pts[:, 1::2])}
        return {"cloud": pts}

    def _sample_batch(self, shapes, seed_index) -> np.ndarray:
        """(len(shapes), 3, n) points of the shapes' meshes, drawn in one
        native call seeded from item `seed_index`."""
        meshes = [self._read_mesh(i) for i in shapes]
        bounds = [np.cumsum([0] + [len(m[j]) for m in meshes])
                  for j in (0, 1)]
        n = 2 * self.cloud_size if self.return_eval_cloud else self.cloud_size
        seed = int(self._rng(seed_index).integers(0, 2 ** 62))
        return native.sample_batch_native(
            np.concatenate([v for v, _ in meshes]), bounds[0],
            np.concatenate([f for _, f in meshes]), bounds[1],
            n_samples=n, seed=seed)

    def _finalize(self, sample, i):
        if self.return_original_scale:
            sample["orig_c"] = self.original_centers[i]
            sample["orig_s"] = self.original_scales[i]
        if self.return_bbox_scale:
            sample["bbox_c"] = self.bbox_centers[i]
            sample["bbox_s"] = self.bbox_scales[i]
        if self.cloud_transform is not None:
            sample = self.cloud_transform(sample)
        if self.sample_labels:
            sample["label"] = self.labels[i]
        return sample

    def __getitem__(self, i):
        rng = self._rng(i)
        if self.chosen_label is not None:
            i = self.chosen_label_inds[i]
        vertices, faces = self._read_mesh(i)
        sample = sample_cloud(vertices, faces, size=self.cloud_size,
                              return_eval_cloud=self.return_eval_cloud,
                              rng=rng)
        return self._finalize(sample, i)

    def get_batch(self, indices):
        """The samples of `indices`, their clouds drawn by one
        multithreaded native call (csrc/sampler.cpp), then each sample's
        metadata and transforms; a list of sample dicts."""
        if self.chosen_label is not None:
            indices = [int(self.chosen_label_inds[i]) for i in indices]
        else:
            indices = [int(i) for i in indices]
        pts = self._sample_batch(indices, indices[0])
        return [self._finalize(self._split(pts[b]), i)
                for b, i in enumerate(indices)]


class ShapeNetAllDataset(ShapeNetCoreDataset):
    """ShapeNetAll13 (3D-R2N2 renderings): each shape has 24 rendered
    views, and the dataset's length is 24 x the shapes."""

    VIEWS = 24

    def __init__(self, path2data: Optional[str] = None, part: str = "train",
                 images_fname: str = "images.h5", image_transform=None,
                 **kwargs):
        self.images_fname = images_fname
        self.image_transform = image_transform
        self.images_file = None
        super().__init__(path2data, part=part, **kwargs)

    def _images(self) -> Mapping:
        if self.store is not None:
            return self.store
        if self.images_file is None:
            self.images_file = _open_h5(
                os.path.join(self.path2data, self.images_fname))
        return self.images_file

    def close(self):
        super().close()
        if self.images_file is not None:
            self.images_file.close()
            self.images_file = None

    def __len__(self):
        return self.VIEWS * self.n_shapes()

    def _view(self, i):
        """(shape index, image index) of item i."""
        i = int(i)
        if self.chosen_label is not None:
            sh_i = int(self.chosen_label_inds[i // self.VIEWS])
            return sh_i, self.VIEWS * sh_i + (i % self.VIEWS)
        return i // self.VIEWS, i

    def _finalize(self, sample, i):
        if self.image_transform is not None:
            sample["image"] = self.image_transform(sample["image"])
        return super()._finalize(sample, i)

    def _image(self, im_i) -> np.ndarray:
        return np.asarray(self._images()[self.part + "_images"][im_i])

    def __getitem__(self, i):
        rng = self._rng(i)
        sh_i, im_i = self._view(i)
        vertices, faces = self._read_mesh(sh_i)
        sample = sample_cloud(vertices, faces, size=self.cloud_size,
                              return_eval_cloud=self.return_eval_cloud,
                              rng=rng)
        sample["image"] = self._image(im_i)
        return self._finalize(sample, sh_i)

    def get_batch(self, indices):
        """As ShapeNetCoreDataset.get_batch: the shapes' clouds in one
        native call, seeded from the first view's image index; each
        view's image read and transformed."""
        views = [self._view(i) for i in indices]
        pts = self._sample_batch([sh for sh, _ in views], views[0][1])
        samples = []
        for b, (sh_i, im_i) in enumerate(views):
            sample = self._split(pts[b])
            sample["image"] = self._image(im_i)
            samples.append(self._finalize(sample, sh_i))
        return samples
