"""The port's offline preprocessing against the JAX package's: its own
ObjMesh (go_with_the_flows_tpu_torch/data/objmesh.py) against the JAX
package's, array for array and bit for bit (tolerance 0), on the messy
cube of tests/test_preprocess.py and on seeded messy OBJs; its PNG
reader (data/png.py) against the pixels a tiny encoder here wrote and
against cv2; and its three preprocessing CLIs (cli/
preprocess_shapenetcore, resample_shapenetcore, preprocess_shapenetall),
each run as `python -m`, against the JAX package's root scripts on
miniature ShapeNet layouts built here: every h5 dataset equal in name,
dtype, shape, chunking and bytes."""

import csv
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from go_with_the_flows_tpu.data.objmesh import ObjMesh as JaxObjMesh
from go_with_the_flows_tpu_torch.data.objmesh import ObjMesh
from go_with_the_flows_tpu_torch.data.png import decode_png, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")

# tests/test_preprocess.py's messy cube (copied): comments, a duplicate
# vertex (9 == 1), a degenerate face, a duplicate face, an empty group
MESSY_OBJ = """# messy cube
g body
v -1 -1 -1
v -1 -1 1
v -1 1 -1
v -1 1 1
v 1 -1 -1
v 1 -1 1
v 1 1 -1
v 1 1 1
v -1 -1 -1
f 1 2 4
f 1 4 3
f 5 7 8
f 5 8 6
f 1 5 6
f 1 6 2
f 3 4 8
f 3 8 7
f 1 3 7
f 1 7 5
f 2 6 8
f 2 8 4
f 2 8 4
f 9 2 4
f 1 1 2
g empty_group
"""


def messy_obj(seed: int) -> str:
    """A seeded OBJ with what cleanup must handle: a jittered grid
    surface in two groups, near-duplicates of some vertices within the
    5e-6 merge tolerance and some just beyond it (and a chain of three,
    the middle within 5e-6 of both ends, the ends beyond it of each
    other), repeated faces (the same triple in another order, in both
    groups), quads, degenerate and collinear faces, faces with texture
    and normal indices, an empty group, an 'o' record, lines and
    comments."""
    rng = np.random.RandomState(seed)
    n = 6 + seed % 3
    xs, ys = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    zs = 0.3 * rng.randn(n, n)
    verts = [list(v) for v in np.stack([xs, ys, zs], -1).reshape(-1, 3)]
    base = len(verts)
    dup = {}  # original index -> its near-duplicates' indices (0-based)
    for i in rng.choice(base, 6, replace=False):
        for dist in (3e-6, 7e-6) if i % 2 else (4.5e-6,):
            d = rng.randn(3)
            verts.append(list(np.asarray(verts[i]) + dist * d
                              / np.linalg.norm(d)))
            dup.setdefault(int(i), []).append(len(verts) - 1)
    chain = int(rng.randint(base))
    step = np.array([1.0, 0.0, 0.0])
    for k in (1, 2):  # 4e-6 and 8e-6 from the chain's first vertex
        verts.append(list(np.asarray(verts[chain]) + 4e-6 * k * step))
    dup.setdefault(chain, []).append(len(verts) - 2)

    def vid(r, c):  # a grid vertex, now and then through a duplicate
        i = r * n + c
        if i in dup and rng.rand() < 0.5:
            return dup[i][rng.randint(len(dup[i]))]
        return i

    lines = ["# seeded messy mesh %d" % seed, "o part"]
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            if rng.rand() < 0.3:
                faces.append([vid(r, c), vid(r, c + 1), vid(r + 1, c + 1),
                              vid(r + 1, c)])
            else:
                faces.append([vid(r, c), vid(r, c + 1), vid(r + 1, c + 1)])
                faces.append([vid(r, c), vid(r + 1, c + 1), vid(r + 1, c)])
    faces.append([0, 0, 1])               # degenerate
    faces.append([0, 1, 2])               # collinear: a grid row
    tri = next(f for f in faces if len(f) == 3)
    faces.append(tri[::-1])               # repeated in another order
    lines += ["v %r %r %r" % tuple(map(float, v)) for v in verts]
    half = len(faces) // 2
    for gi, chunk in enumerate((faces[:half], faces[half:])):
        lines.append(f"g group{gi}")
        for k, f in enumerate(chunk):
            if k % 5 == 0:
                lines.append("f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}"
                                             for i in f))
            else:
                lines.append("f " + "  ".join(str(i + 1) for i in f))
        lines.append("l 1 2")
    lines.append("f " + " ".join(str(i + 1) for i in faces[0]))  # again
    lines.append("g empty")
    return "\n".join(lines) + "\n"


def _cleaned(cls, path):
    mesh = cls(str(path))
    mesh.cleanup()
    return mesh.reformat()


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3, 4, 5])
def test_objmesh_bit_equal_to_jax(tmp_path, seed):
    """cleanup() then reformat(): every array the JAX ObjMesh's, dtype,
    shape and bits (tolerance 0). seed None is the messy cube."""
    path = tmp_path / "mesh.obj"
    path.write_text(MESSY_OBJ if seed is None else messy_obj(seed))
    got, want = _cleaned(ObjMesh, path), _cleaned(JaxObjMesh, path)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key
    if seed is None:
        assert got["vertices_c"].shape == (8, 3)
        assert got["faces_vc"].shape == (12, 3)
    else:  # the merge took some duplicates and left those beyond 5e-6
        raw = ObjMesh(str(path))
        assert len(got["vertices_c"]) < len(raw.vertices)


# --------------------------------------------------------------------- #
# the PNG reader                                                        #
# --------------------------------------------------------------------- #

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(pixels, filters, colour=6, depth=8, interlace=0,
               idat_parts=1) -> bytes:
    """A PNG of `pixels` (H, W, C) uint8, row r filtered by type
    filters[r % len(filters)], the header fields as given, the image data
    split into `idat_parts` IDAT chunks."""
    h, w, bpp = pixels.shape
    img = pixels.astype(np.int64).reshape(h, w * bpp)
    raw = bytearray()
    for r in range(h):
        t = filters[r % len(filters)]
        x = img[r]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        b = img[r - 1] if r else np.zeros_like(x)
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        pred = [0 * x, a, b, (a + b) // 2, _paeth(a, b, c)][t]
        raw.append(t)
        raw += ((x - pred) % 256).astype(np.uint8).tobytes()
    data = zlib.compress(bytes(raw))
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + b"".join(_chunk(b"IDAT", data[i:j])
                       for i, j in zip(cut, cut[1:]))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("colour", [2, 6])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4, 4, 3],
                                     [2, 4, 4, 1, 3, 0, 0]])
def test_png_reader_filters(colour, filters):
    """Each row filter alone and all five mixed, RGB and RGBA: the
    pixels that were encoded (RGB gains alpha 255), exactly."""
    rng = np.random.RandomState(sum(filters) + colour)
    bpp = 4 if colour == 6 else 3
    pixels = rng.randint(0, 256, (23, 17, bpp)).astype(np.uint8)
    pixels[5:9, 3:12] = pixels[5, 3]  # a flat patch
    got = decode_png(encode_png(pixels, filters, colour, idat_parts=3))
    want = pixels if colour == 6 else np.concatenate(
        [pixels, np.full((23, 17, 1), 255, np.uint8)], axis=2)
    assert got.dtype == np.uint8 and got.shape == (23, 17, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", ["interlaced", "16-bit", "paletted",
                                  "grey", "bad CRC", "truncated"])
def test_png_reader_refuses(what):
    pixels = np.zeros((4, 4, 4), np.uint8)
    if what == "interlaced":
        data = encode_png(pixels, [0], interlace=1)
    elif what == "16-bit":
        data = encode_png(np.zeros((4, 4, 8), np.uint8), [0], depth=16)
    elif what == "paletted":
        data = encode_png(np.zeros((4, 4, 1), np.uint8), [0], colour=3)
    elif what == "grey":
        data = encode_png(np.zeros((4, 4, 1), np.uint8), [0], colour=0)
    elif what == "bad CRC":
        data = bytearray(encode_png(pixels, [0]))
        data[-20] ^= 1
        data = bytes(data)
    else:
        data = encode_png(pixels, [0])[:-30]
    with pytest.raises(ValueError):
        decode_png(data)


def _cv2_reads(cv2, path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
    return np.transpose(img, (2, 0, 1))[None].astype(np.uint8)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_png_reader_against_cv2(tmp_path, level):
    """RGBA renderings written by cv2 read as the JAX script reads them
    (cv2.imread + COLOR_BGRA2RGBA, (1, 4, H, W)), exactly."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(level)
    img = rng.randint(0, 256, (137, 137, 4)).astype(np.uint8)
    img[20:90, 40:100] = (10, 200, 30, 255)
    img[:, :10, 3] = 0
    path = tmp_path / "view.png"
    cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = read_png(str(path))
    want = _cv2_reads(cv2, path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# the CLIs against the JAX package's root scripts                       #
# --------------------------------------------------------------------- #

def h5_datasets(path):
    """name -> (dtype, shape, chunks, maxshape, bytes) of every dataset."""
    import h5py

    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k].chunks, f[k].maxshape,
                    np.asarray(f[k][()]).tobytes()) for k in f.keys()}


def assert_same_h5(got_path, want_path):
    got, want = h5_datasets(got_path), h5_datasets(want_path)
    assert sorted(got) == sorted(want)
    for key in want:
        for field, g, w in zip(("dtype", "shape", "chunks", "maxshape",
                                "bytes"), got[key], want[key]):
            assert g == w, (key, field)


def _run(args, timeout=600):
    res = subprocess.run([sys.executable] + args, env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _port_cli(name, *args):
    return _run(["-m", f"go_with_the_flows_tpu_torch.cli.{name}"]
                + [str(a) for a in args])


def _jax_script(name, *args):
    return _run([os.path.join(REPO, name)] + [str(a) for a in args])


# tests/test_preprocess.py's layout: 2 synsets, their models split over
# train, val and test; one shape listed but missing
SPECS = [
    ("2691156", "a0", "train"), ("2691156", "a1", "val"),
    ("2691156", "a2", "test"), ("2958343", "b0", "train"),
    ("2958343", "b1", "train"), ("2958343", "b2", "test"),
    ("2958343", "b3", "val"), ("2691156", "a3", "train"),
]


def shapenetcore_layout(root):
    data_dir = root / "sn"
    rows = []
    for k, (synset, model, part) in enumerate(SPECS):
        if model != "a3":
            d = data_dir / "shapes" / f"0{synset}" / model / "models"
            d.mkdir(parents=True)
            (d / "model_normalized.obj").write_text(
                MESSY_OBJ if k == 0 else messy_obj(k))
        rows.append({"synsetId": synset, "modelId": model, "split": part})
    with open(data_dir / "all.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["synsetId", "modelId",
                                               "split"])
        writer.writeheader()
        writer.writerows(rows)
    return data_dir


def test_shapenetcore_cli_and_resample(tmp_path):
    """preprocess_shapenetcore and resample_shapenetcore: the port's files
    equal the JAX scripts', dataset for dataset; the port's
    ShapeNetCoreDataset reads both."""
    pytest.importorskip("pandas")
    from go_with_the_flows_tpu_torch.data.datasets import ShapeNetCoreDataset

    data_dir = shapenetcore_layout(tmp_path)
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    _jax_script("preprocess_shapenetcore.py", data_dir, want_dir, 1, 2)
    out = _port_cli("preprocess_shapenetcore", data_dir, got_dir, 2, 2)
    assert "a3/models/ missing" in out.stdout
    name = "ShapeNetCore55v2_meshes.h5"
    assert_same_h5(got_dir / name, want_dir / name)
    _jax_script("resample_shapenetcore.py", want_dir / name)
    _port_cli("resample_shapenetcore", got_dir / name)
    resampled = "ShapeNetCore55v2_meshes_resampled.h5"
    assert_same_h5(got_dir / resampled, want_dir / resampled)
    for fname, n in ((name, 3), (resampled, 3)):
        ds = ShapeNetCoreDataset(str(got_dir), part="train",
                                 meshes_fname=fname, cloud_size=16,
                                 return_eval_cloud=True)
        assert len(ds) == n
        s = ds[0]
        assert s["cloud"].shape == (3, 16)
        assert np.isfinite(s["cloud"]).all()
        ds.close()


def shapenetall_layout(cv2, root, copy: bool):
    """2 synsets x 5 shapes, each with 24 seeded 137 x 137 RGBA views
    written by cv2 and a model.obj: under ShapeNetMesh/ already, or
    (copy) in a ShapeNetCore.v1-style directory of their own."""
    sna, snc1 = root / "sna", root / "snc1"
    k = 0
    for cat in ("02691156", "03001627"):
        for m in range(5):
            name = f"{cat[-3:]}m{m}"
            views = sna / "ShapeNetRendering" / cat / name / "rendering"
            views.mkdir(parents=True)
            rng = np.random.RandomState(k)
            for v in range(24):
                img = rng.randint(0, 256, (137, 137, 4)).astype(np.uint8)
                img[30:100, 30:100] = rng.randint(0, 256, 4)
                cv2.imwrite(str(views / f"{v:02d}.png"), img)
            mesh_dir = (snc1 / cat / name if copy
                        else sna / "ShapeNetMesh" / cat / name)
            mesh_dir.mkdir(parents=True)
            (mesh_dir / "model.obj").write_text(messy_obj(10 + k))
            k += 1
    return sna, snc1


@pytest.mark.parametrize("copy", [False, True])
def test_shapenetall_cli(tmp_path, copy):
    """preprocess_shapenetall, with --skip_copy and with the copy from a
    ShapeNetCore.v1-style directory: both h5 files equal the JAX
    script's, dataset for dataset; the port's ShapeNetAllDataset reads
    them."""
    cv2 = pytest.importorskip("cv2")
    from go_with_the_flows_tpu_torch.data.datasets import ShapeNetAllDataset

    runs = {}
    for side in ("jax", "port"):
        sna, snc1 = shapenetall_layout(cv2, tmp_path / side, copy)
        out = tmp_path / side / "out"
        args = [sna, snc1, out, 2, 48] + ([] if copy else ["--skip_copy"])
        if side == "jax":
            _jax_script("preprocess_shapenetall.py", *args)
        else:
            _port_cli("preprocess_shapenetall", *args)
        runs[side] = out
    for name in ("ShapeNetAll13_images.h5", "ShapeNetAll13_meshes.h5"):
        assert_same_h5(runs["port"] / name, runs["jax"] / name)
    ds = ShapeNetAllDataset(str(runs["port"]), part="train",
                            meshes_fname="ShapeNetAll13_meshes.h5",
                            images_fname="ShapeNetAll13_images.h5",
                            cloud_size=16)
    assert len(ds) == 24 * 8  # 4 of each category's 5 shapes train
    s = ds[25]
    assert s["cloud"].shape == (3, 16) and np.isfinite(s["cloud"]).all()
    ds.close()
