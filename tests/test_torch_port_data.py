"""The port's data path (go_with_the_flows_tpu_torch/data) against the
JAX package's, on h5 files written by the JAX package's
data/synthetic.py: surface sampling (numpy and native), the ShapeNet
datasets (`__getitem__` and `get_batch`, with chosen_label,
return_original_scale, return_bbox_scale and sample_labels), two
shuffled epochs of the DataLoader, the cloud and image transforms, the
cv2-free Resize, and the in-memory store against the h5 store.

Tolerances: the numpy sampling path, the datasets' metadata and every
transform but Resize are bit-equal. Native samples: 1e-6 absolute (both
libraries come from the same source and flags, but the JAX package's
may have been built on another CPU; the test prints whether the bits are
equal). Resize against cv2.resize: 1e-6 absolute on [0, 1] images; the
composed image pipeline (normalised by stds of 0.25) 1e-5.
"""

import os

import cv2
import numpy as np
import pytest

from go_with_the_flows_tpu.data import cloud_sampling as j_sampling
from go_with_the_flows_tpu.data import cloud_transforms as j_ct
from go_with_the_flows_tpu.data import datasets as j_datasets
from go_with_the_flows_tpu.data import image_transforms as j_it
from go_with_the_flows_tpu.data import loader as j_loader
from go_with_the_flows_tpu.data import native as j_native
from go_with_the_flows_tpu.data.synthetic import (
    write_synthetic_images_h5,
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu_torch.data import cloud_sampling as p_sampling
from go_with_the_flows_tpu_torch.data import cloud_transforms as p_ct
from go_with_the_flows_tpu_torch.data import datasets as p_datasets
from go_with_the_flows_tpu_torch.data import image_transforms as p_it
from go_with_the_flows_tpu_torch.data import loader as p_loader
from go_with_the_flows_tpu_torch.data import native as p_native
from go_with_the_flows_tpu_torch.data import synthetic as p_synthetic

NATIVE_ATOL = 1e-6
IMAGE_CONFIG = dict(
    image_resize=True, image_size=[24, 24], image_pad=True,
    image_pad_size=[2, 2], image_add_grayscale=True, image_remove_alpha=True,
    image_normalize=True, image_means=[0.5, 0.4, 0.3, 0.2],
    image_stds=[0.25, 0.25, 0.25, 0.25], image_noise=False)


@pytest.fixture(scope="module")
def h5dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    # cubes (12 faces: the numpy path in __getitem__) by the JAX writer
    write_synthetic_meshes_h5(str(d / "meshes.h5"), n_shapes=6,
                              labels=[1, 2, 1, 3, 1, 2], seed=1)
    write_synthetic_images_h5(str(d / "images.h5"), n_shapes=6,
                              parts=("train", "val", "test"), hw=20, seed=2)
    # 320-face ellipsoids (the native path) by the port's writer
    p_synthetic.write_synthetic_meshes_h5(
        str(d / "spheres.h5"), n_shapes=4, labels=[0, 1, 0, 1], seed=3,
        sphere_level=2)
    return d


def _assert_native_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    print(f"{what}: bits equal {np.array_equal(got, want)}")
    np.testing.assert_allclose(got, want, rtol=0, atol=NATIVE_ATOL,
                               err_msg=what)


def _assert_samples_equal(got, want, native):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key in ("cloud", "eval_cloud") and native:
            _assert_native_close(g, w, key)
        elif key == "image":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _code(path):
    """A C++ source without its leading comment block."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("#include"))
    return lines[start:]


def test_sampler_source_is_the_jax_packages():
    """The port's csrc/sampler.cpp is the JAX package's code (only the
    leading comment differs), so both draw the same clouds."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _code(p_native.SRC) == _code(os.path.join(root, "csrc",
                                                     "sampler.cpp"))
    assert p_native.SRC == os.path.join(root, "go_with_the_flows_tpu_torch",
                                        "csrc", "sampler.cpp")
    assert p_native.lib_path().startswith(p_native.BUILD_DIR)


def test_native_sampler_builds_here():
    assert p_native.get_lib() is not None
    assert j_native.native_available()


@pytest.mark.parametrize("eval_cloud", [False, True])
def test_sample_cloud_numpy_path_is_bit_equal(eval_cloud):
    v, f = p_synthetic._unit_cube_mesh(np.random.default_rng(0))
    assert len(f) == 12
    got = p_sampling.sample_cloud(v, f, 100, eval_cloud,
                                  rng=np.random.default_rng(5))
    want = j_sampling.sample_cloud(v, f, 100, eval_cloud,
                                   rng=np.random.default_rng(5))
    _assert_samples_equal(got, want, native=False)


@pytest.mark.parametrize("eval_cloud", [False, True])
def test_sample_cloud_native_path_matches_jax(eval_cloud):
    v, f = p_synthetic.icosphere(2)
    assert len(f) == 320 > 64
    v = v.astype(np.float32) * np.float32([0.5, 0.3, 0.2])
    got = p_sampling.sample_cloud(v, f, 500, eval_cloud,
                                  rng=np.random.default_rng(6))
    want = j_sampling.sample_cloud(v, f, 500, eval_cloud,
                                   rng=np.random.default_rng(6))
    _assert_samples_equal(got, want, native=True)
    assert got["cloud"].shape == (3, 500)


def test_sample_batch_native_matches_jax():
    rng = np.random.default_rng(7)
    meshes = [p_synthetic._ellipsoid_mesh(rng, p_synthetic.icosphere(level))
              for level in (1, 2, 0)]
    verts = np.concatenate([m[0] for m in meshes])
    faces = np.concatenate([m[1] for m in meshes])
    vb = np.cumsum([0] + [len(m[0]) for m in meshes])
    fb = np.cumsum([0] + [len(m[1]) for m in meshes])
    got = p_native.sample_batch_native(verts, vb, faces, fb, 300, seed=11)
    want = j_native.sample_batch_native(verts, vb, faces, fb, 300, seed=11)
    assert got.shape == (3, 3, 300)
    _assert_native_close(got, want, "batch")


def test_native_rejects_a_face_past_the_vertices():
    v, f = p_synthetic.icosphere(1)
    f = f.copy()
    f[0, 0] = len(v)
    with pytest.raises(ValueError):
        p_native.sample_cloud_native(v, f, 10, 0)


def test_failed_sampler_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(p_native, "SRC", str(bad))
    monkeypatch.setattr(p_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(p_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        p_native.get_lib()
    v, f = p_synthetic.icosphere(2)
    with pytest.raises(RuntimeError):  # no quiet drop to numpy
        p_sampling.sample_cloud(v.astype(np.float32), f, 10)


def test_sampler_library_is_keyed_to_source_flags_and_host(monkeypatch):
    """A library built with -march=native is found again only by the
    same source, flags and target; any change names another file."""
    path = p_native.lib_path()
    assert path == p_native.lib_path()
    run = p_native._gxx

    def other_cpu(*args):
        out = run(*args)
        if "--help=target" in args:
            out.stdout += "  -mavx512f  [enabled]\n"
        return out

    monkeypatch.setattr(p_native, "_gxx", other_cpu)
    assert p_native.lib_path() != path
    monkeypatch.setattr(p_native, "_gxx", run)
    monkeypatch.setattr(p_native, "GXX_FLAGS", [*p_native.GXX_FLAGS, "-g"])
    assert p_native.lib_path() != path


def test_sample_batch_native_bits_do_not_depend_on_threads(monkeypatch):
    rng = np.random.default_rng(8)
    meshes = [p_synthetic._ellipsoid_mesh(rng, p_synthetic.icosphere(2))
              for _ in range(4)]
    args = (np.concatenate([m[0] for m in meshes]),
            np.cumsum([0] + [len(m[0]) for m in meshes]),
            np.concatenate([m[1] for m in meshes]),
            np.cumsum([0] + [len(m[1]) for m in meshes]), 200)
    many = p_native.sample_batch_native(*args, seed=3)
    monkeypatch.setattr(p_native, "sampler_threads", lambda: 1)
    np.testing.assert_array_equal(p_native.sample_batch_native(*args, seed=3),
                                  many)


CORE_CASES = [
    ("meshes.h5", dict()),
    ("meshes.h5", dict(chosen_label=1, return_original_scale=True,
                       return_bbox_scale=True, sample_labels=True)),
    ("spheres.h5", dict(chosen_label=1, sample_labels=True)),
    ("spheres.h5", dict(return_original_scale=True, cloud_transform="scale")),
]


def _cloud_transform(name, module):
    if name is None:
        return None
    return module.ComposeCloudTransformation(
        cloud_scale=True, cloud_scale_scale=2.0, cloud_translate=True,
        cloud_translate_shift=[0.1, -0.2, 0.3])[0]


@pytest.mark.parametrize("fname,kwargs", CORE_CASES)
def test_core_dataset_matches_jax(h5dir, fname, kwargs):
    kwargs = dict(kwargs)
    transform = kwargs.pop("cloud_transform", None)
    common = dict(part="train", meshes_fname=fname, cloud_size=64,
                  return_eval_cloud=True, base_seed=4, **kwargs)
    got = p_datasets.ShapeNetCoreDataset(
        str(h5dir), cloud_transform=_cloud_transform(transform, p_ct),
        **common)
    want = j_datasets.ShapeNetCoreDataset(
        str(h5dir), cloud_transform=_cloud_transform(transform, j_ct),
        **common)
    assert len(got) == len(want) > 0
    native = fname == "spheres.h5"
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(want)):
            _assert_samples_equal(got[i], want[i], native)
        order = list(range(len(want)))[::-1]
        for g, w in zip(got.get_batch(order), want.get_batch(order)):
            _assert_samples_equal(g, w, native=True)
    got.close()
    want.close()


def _all_dataset(module, ct, it, h5dir, **kwargs):
    return module.ShapeNetAllDataset(
        str(h5dir), part="train", meshes_fname="meshes.h5",
        images_fname="images.h5", cloud_size=32, return_eval_cloud=True,
        image_transform=it.ComposeImageTransformation(**IMAGE_CONFIG),
        cloud_transform=_cloud_transform("scale", ct), base_seed=2, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(chosen_label=2, return_original_scale=True,
                 sample_labels=True, return_bbox_scale=True)])
def test_all_dataset_matches_jax(h5dir, kwargs):
    got = _all_dataset(p_datasets, p_ct, p_it, h5dir, **kwargs)
    want = _all_dataset(j_datasets, j_ct, j_it, h5dir, **kwargs)
    assert len(got) == len(want) == 24 * (6 if not kwargs else 2)
    for i in (0, 5, 23, 24, len(want) - 1):
        _assert_samples_equal(got[i], want[i], native=False)
    indices = [len(want) - 1, 3, 30, 0]
    for g, w in zip(got.get_batch(indices), want.get_batch(indices)):
        _assert_samples_equal(g, w, native=True)
        assert g["image"].shape == (4, 28, 28)


@pytest.mark.parametrize("kind", ["core", "all"])
def test_two_shuffled_loader_epochs_match_jax(h5dir, kind):
    if kind == "core":
        datasets = [m.ShapeNetCoreDataset(str(h5dir), part="val",
                                          meshes_fname="spheres.h5",
                                          cloud_size=48,
                                          return_eval_cloud=True,
                                          base_seed=9)
                    for m in (p_datasets, j_datasets)]
        extra, batch = {}, 2
    else:
        datasets = [_all_dataset(p_datasets, p_ct, p_it, h5dir),
                    _all_dataset(j_datasets, j_ct, j_it, h5dir)]
        # the port's images stay NCHW
        extra, batch = {"image_nhwc": False}, 16
    got = p_loader.DataLoader(datasets[0], batch, shuffle=True, seed=5,
                              prefetch=1)
    want = j_loader.DataLoader(datasets[1], batch, shuffle=True, seed=5,
                               prefetch=1, **extra)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches = list(zip(got, want))
        assert len(batches) == len(want) > 1
        for g, w in batches:
            _assert_samples_equal(g, w, native=True)


@pytest.mark.parametrize("name,kwargs", [
    ("Scale2OrigCloud", dict(cloud_rescale2orig=True,
                             cloud_recenter2orig=True)),
    ("TranslateCloud", dict(cloud_translate_shift=[0.1, 0.2, -0.3])),
    ("ScaleCloud", dict(cloud_scale_scale=2.0)),
    ("AddNoise2Cloud", dict(cloud_noise_scale=0.01, rng="seeded")),
    ("CenterCloud", None),
    ("Random3DRotation", dict(rng="seeded")),
])
def test_cloud_transforms_match_jax(name, kwargs):
    rng = np.random.default_rng(12)
    sample = {"cloud": rng.normal(size=(3, 50)).astype(np.float32),
              "eval_cloud": rng.normal(size=(3, 50)).astype(np.float32),
              "orig_c": rng.normal(size=3).astype(np.float32),
              "orig_s": np.float32(1.5)}
    outs = []
    for module in (p_ct, j_ct):
        kw = dict(kwargs or {})
        if kw.get("rng") == "seeded":
            kw["rng"] = np.random.default_rng(13)
        t = getattr(module, name)(**kw)
        outs.append(t({k: np.copy(v) for k, v in sample.items()}))
    _assert_samples_equal(*outs, native=False)


def test_composed_cloud_transforms_match_jax():
    config = dict(cloud_translate=True, cloud_translate_shift=[0.1, 0, 0],
                  cloud_scale=True, cloud_scale_scale=2.0,
                  cloud_center=True)
    sample = {"cloud": np.random.default_rng(1).normal(
        size=(3, 40)).astype(np.float32)}
    for got, want in zip(p_ct.ComposeCloudTransformation(**config),
                         j_ct.ComposeCloudTransformation(**config)):
        _assert_samples_equal(got(dict(sample)), want(dict(sample)),
                              native=False)
    assert p_ct.ComposeCloudTransformation() == (None, None)


@pytest.mark.parametrize("name,kwargs", [
    ("ToFloat", None), ("Pad", dict(image_pad_size=[3, 1])),
    ("AddGrayscale", None), ("RemoveAlpha", None),
    ("NormalizeImages", dict(image_means=[0.1] * 5, image_stds=[0.3] * 5)),
    ("AddNoise2Images", dict(image_noise_scale=0.05, rng="seeded")),
])
def test_image_transforms_match_jax(name, kwargs):
    image = np.random.default_rng(3).integers(0, 256, size=(5, 9, 11)
                                              ).astype(np.uint8)
    if name != "ToFloat":
        image = image.astype(np.float32) / 255.0
    outs = []
    for module in (p_it, j_it):
        kw = dict(kwargs or {})
        if kw.get("rng") == "seeded":
            kw["rng"] = np.random.default_rng(4)
        outs.append(getattr(module, name)(**kw)(np.copy(image)))
    assert outs[0].dtype == outs[1].dtype
    np.testing.assert_array_equal(outs[0], outs[1])


def test_composed_image_transforms_match_jax():
    image = np.random.default_rng(5).integers(0, 256, size=(4, 137, 137)
                                              ).astype(np.uint8)
    config = dict(IMAGE_CONFIG, image_size=[224, 224], image_pad=False)
    got = p_it.ComposeImageTransformation(**config)(image)
    want = j_it.ComposeImageTransformation(**config)(image)
    assert got.shape == want.shape == (4, 224, 224)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw_in,size", [
    ((137, 137), (224, 224)),  # config_SVR.yaml's upscale
    ((137, 137), (64, 64)),    # a downscale: no antialiasing
    ((137, 100), (300, 50)),   # (width, height), as cv2's dsize
    ((5, 7), (11, 3)),
])
def test_resize_matches_cv2(hw_in, size):
    image = np.random.default_rng(8).random((4, *hw_in), dtype=np.float32)
    got = p_it.Resize(image_size=list(size))(image)
    want = np.transpose(cv2.resize(np.transpose(image, (1, 2, 0)), size),
                        (2, 0, 1))
    assert got.shape == want.shape == (4, size[1], size[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_synthetic_arrays_equal_the_jax_writers(h5dir):
    import h5py

    arrays = {**p_synthetic.synthetic_meshes(n_shapes=6,
                                             labels=[1, 2, 1, 3, 1, 2],
                                             seed=1),
              **p_synthetic.synthetic_images(
                  n_shapes=6, parts=("train", "val", "test"), hw=20, seed=2)}
    seen = set()
    for fname in ("meshes.h5", "images.h5"):
        with h5py.File(str(h5dir / fname), "r") as f:
            for key in f:
                assert f[key].dtype == arrays[key].dtype, key
                np.testing.assert_array_equal(f[key][()], arrays[key])
                seen.add(key)
    assert seen == set(arrays)


def test_icosphere_is_closed():
    v, f = p_synthetic.icosphere(4)
    assert f.shape == (5120, 3) and v.shape == (2562, 3)
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()  # every edge between exactly two faces


def test_store_equals_h5(h5dir):
    """A dataset over the arrays of data/synthetic.py and one over the h5
    file the same arrays were written to give equal items and batches."""
    store = {**p_synthetic.synthetic_meshes(n_shapes=4, labels=[0, 1, 0, 1],
                                            seed=3, sphere_level=2),
             **p_synthetic.synthetic_images(n_shapes=6,
                                            parts=("train", "val", "test"),
                                            hw=20, seed=2)}
    for cls, kwargs in ((p_datasets.ShapeNetCoreDataset,
                         dict(chosen_label=1, sample_labels=True)),
                        (p_datasets.ShapeNetAllDataset,
                         dict(images_fname="images.h5",
                              return_original_scale=True))):
        common = dict(part="train", meshes_fname="spheres.h5", cloud_size=40,
                      return_eval_cloud=True, base_seed=1, **kwargs)
        from_h5 = cls(str(h5dir), **common)
        from_store = cls(store=store, **common)
        assert len(from_h5) == len(from_store)
        for i in range(0, len(from_h5), 5):
            _assert_samples_equal(from_store[i], from_h5[i], native=False)
        batch = list(range(len(from_h5)))[::3]
        for g, w in zip(from_store.get_batch(batch),
                        from_h5.get_batch(batch)):
            _assert_samples_equal(g, w, native=False)
        from_h5.close()


def test_dataset_needs_a_path_or_a_store():
    with pytest.raises(ValueError):
        p_datasets.ShapeNetCoreDataset()
