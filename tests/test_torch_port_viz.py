"""The port's reconstruction figures (go_with_the_flows_tpu_torch/viz)
against the JAX package's viz/, on the CPU:

  * (d) the viewing rotation against JAX `viz/tb.py:_rotate` (scipy's
    extrinsic xyz Euler rotation) within 1e-6, and the palettes equal;
  * (e) the rasters: every point's dot painted in its label's color at
    its projected pixels, every other pixel the white background, the
    SVR figure's first panel the conditioning image's channels 1-3; the
    tags, steps and counts of both figure functions through a recording
    writer; and the loops' cadence against the JAX loops driven with the
    same stub steps and loaders: train()'s SVR figures on the checkpoint
    cadence, evaluate_val()'s figures every `logging_img_frequency`
    epochs, nothing without `logging_img`;
  * (f) viz/open3d_utils.py through a stub of the open3d API (a copy of
    tests/test_open3d_utils.py's, not imported from it).

Tolerance: the rotation 1e-6; everything else exact.
"""

import sys
import types

import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.viz import open3d_utils as j_o3u
from go_with_the_flows_tpu.viz import tb as jtb
from go_with_the_flows_tpu_torch.train import loops
from go_with_the_flows_tpu_torch.viz import open3d_utils as o3u
from go_with_the_flows_tpu_torch.viz import tb


class RecordingWriter:
    """Records add_image / add_figure calls as (tag, step), and the
    images."""

    def __init__(self):
        self.calls, self.images = [], []

    def add_scalar(self, tag, value, step):
        pass

    def add_image(self, tag, img, step, dataformats="CHW"):
        assert dataformats == "HWC"
        self.calls.append((tag, step))
        self.images.append(np.asarray(img))

    def add_figure(self, tag, fig, step):
        import matplotlib.pyplot as plt

        self.calls.append((tag, step))
        plt.close(fig)


def _clouds(n_clouds, n, seed=0):
    rng = np.random.RandomState(seed)
    gts = rng.randn(n_clouds, 3, n).astype(np.float32)
    samples = rng.randn(n_clouds, 3, n).astype(np.float32) * 0.5
    labels = rng.randint(1, 9, size=(n_clouds, n))
    return gts, samples, labels


# ------------------------------------------------------------------ #
# (d) rotation and palette                                             #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("angles", [tb.ANGLES, (10.0, -70.0, 33.0)])
def test_rotation_is_the_jax_modules(angles):
    pts = np.random.RandomState(1).randn(3, 200) * 2.0
    np.testing.assert_allclose(tb._rotate(pts, angles),
                               jtb._rotate(pts, angles), rtol=0, atol=1e-6)


def test_palettes_are_the_jax_modules():
    np.testing.assert_array_equal(tb._PALETTE, jtb._PALETTE)
    assert tb._PALETTE.dtype == jtb._PALETTE.dtype
    np.testing.assert_array_equal(o3u._PALETTE, j_o3u._PALETTE)


# ------------------------------------------------------------------ #
# (e) rasters                                                          #
# ------------------------------------------------------------------ #

def _painted(panel):
    return (panel != tb.BACKGROUND).any(axis=2)


def test_cloud_panel_paints_the_projected_pixels():
    """Each point's DOT x DOT square at its projection, in its label's
    color where no later point covers it; nothing else painted; the
    projection is the rotated x to the right and y up."""
    gts, samples, labels = _clouds(1, 300)
    cloud, lab = samples[0], labels[0]
    panel = tb.cloud_panel(cloud, lab)
    rows, cols = tb.project(cloud)
    want = np.zeros((tb.PANEL, tb.PANEL), bool)
    color = np.full((tb.PANEL, tb.PANEL, 3), tb.BACKGROUND, np.uint8)
    rgb = np.round(jtb._PALETTE[lab % 7] * 255).astype(np.uint8)
    for i in range(cloud.shape[1]):
        want[rows[i]:rows[i] + tb.DOT, cols[i]:cols[i] + tb.DOT] = True
        color[rows[i]:rows[i] + tb.DOT, cols[i]:cols[i] + tb.DOT] = rgb[i]
    np.testing.assert_array_equal(_painted(panel), want)
    np.testing.assert_array_equal(panel, color)
    # orientation: the rightmost and the topmost rotated points
    xy = jtb._rotate(cloud)[:2]
    assert cols[np.argmax(xy[0])] == cols.max()
    assert rows[np.argmax(xy[1])] == rows.min()
    assert rows.min() >= 0 and cols.max() <= tb.PANEL - tb.DOT
    # one scale for both axes: the wider extent spans the panel less
    # its margins
    extent = max(cols.max() - cols.min(), rows.max() - rows.min())
    assert abs(extent - (tb.PANEL - tb.DOT) / 1.1) <= 2


def test_figures_and_their_schedule():
    """Both figure functions: the JAX functions' tags, steps and counts
    (at most max_figures, fewer clouds fewer figures), and each figure's
    panels: ground truth in label 0's grey, the reconstruction by
    label, the SVR image's channels 1-3 first."""
    gts, samples, labels = _clouds(6, 64)
    images = np.random.RandomState(2).rand(6, 4, 20, 20).astype(np.float32)
    for n, max_figures in ((6, 4), (2, 4), (6, 1)):
        got, want = RecordingWriter(), RecordingWriter()
        tb.add_figures_reconstruction_tb(gts[:n], samples[:n], labels[:n],
                                         got, 7, max_figures)
        jtb.add_figures_reconstruction_tb(gts[:n], samples[:n], labels[:n],
                                          want, 7, max_figures)
        tb.add_svr_reconstruction_tb(images[:n], gts[:n], samples[:n],
                                     labels[:n], got, 11, max_figures)
        jtb.add_svr_reconstruction_tb(images[:n].transpose(0, 2, 3, 1),
                                      gts[:n], samples[:n], labels[:n],
                                      want, 11, max_figures)
        assert got.calls == want.calls
        assert len(got.calls) == 2 * min(n, max_figures)
    grey = np.round(jtb._PALETTE[0] * 255).astype(np.uint8)
    fig = got.images[0]
    assert fig.shape == (tb.PANEL, 2 * tb.PANEL, 3) and fig.dtype == np.uint8
    gt_panel = fig[:, :tb.PANEL]
    assert (gt_panel[_painted(gt_panel)] == grey).all()
    np.testing.assert_array_equal(fig[:, tb.PANEL:],
                                  tb.cloud_panel(samples[0], labels[0]))
    svr = got.images[1]
    assert svr.shape == (tb.PANEL, 3 * tb.PANEL, 3)
    np.testing.assert_array_equal(svr[:, tb.PANEL:], fig)
    # 20 x 20 scaled by 12.8 to 256 x 256, nearest neighbour
    idx = (np.arange(tb.PANEL) / 12.8).astype(int)
    want_img = np.round(images[0, 1:4].transpose(1, 2, 0)[idx][:, idx]
                        * 255).astype(np.uint8)
    np.testing.assert_array_equal(svr[:, :tb.PANEL], want_img)
    # a three-channel image uses channels 0-2, as the JAX module does
    three = tb.image_panel(images[0, :3])
    np.testing.assert_array_equal(
        three, np.round(images[0, :3].transpose(1, 2, 0)[idx][:, idx]
                        * 255).astype(np.uint8))


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _loop_inputs():
    rng = np.random.RandomState(3)
    batches = [{"cloud": rng.randn(2, 3, 16).astype(np.float32),
                "eval_cloud": rng.randn(2, 3, 16).astype(np.float32),
                "image": rng.rand(2, 4, 8, 8).astype(np.float32)}
               for _ in range(5)]
    recon = _clouds(6, 16, seed=4)
    images = rng.rand(6, 4, 8, 8).astype(np.float32)
    return batches, recon, images


@pytest.mark.parametrize("logging_img", [True, False])
def test_loops_draw_on_the_jax_cadence(logging_img):
    """train() over 2 epochs of 5 steps with logging_img_steps 2 (SVR
    figures after steps 2 and 4 of each epoch, at the global step) and
    evaluate_val() over 4 epochs at logging_img_frequency 2 (figures at
    epochs 0 and 2), against the JAX loops with the same stubs; every
    rank's reconstruction is called on the same cadence."""
    import jax.numpy as jnp

    from go_with_the_flows_tpu.train import loops as jloops

    batches, recon, images = _loop_inputs()
    config = dict(logging=True, checkpointing=False, logging_img=logging_img,
                  logging_img_steps=2, logging_img_frequency=2,
                  num_workers=100)
    metrics = {"loss": 1.0, "pnll": 1.0, "gnll": 0.5, "gent": 0.5}
    got, want = RecordingWriter(), RecordingWriter()
    calls = {"port": 0, "jax": 0}

    def recon_fn(which, with_images):
        def fn(state, max_batches=None):
            assert max_batches in (None, 1)
            calls[which] += 1
            return recon + (images,) if with_images else recon
        return fn

    # the port's loops
    state = types.SimpleNamespace(step=0, generator=None)

    def port_step(g, p, generator, warmup=False, images=None):
        return {k: torch.tensor(v) for k, v in metrics.items()}

    for epoch in range(2):
        loops.train(_Loader(batches), port_step, state, epoch, 0, False,
                    "cpu", svr=True, writer=got, per_step_tb=True,
                    svr_recon_fn=recon_fn("port", True), **config)
    for epoch in range(4):
        loops.evaluate_val(_Loader(batches), port_step, state, epoch, False,
                           1e4, None, "cpu", writer=got,
                           reconstruct_fn=recon_fn("port", False), **config)

    # the JAX loops, with the same stubs
    jstate = types.SimpleNamespace()

    def jax_train_step(state, g, p, rng, images=None, warmup=False):
        return state, {k: jnp.float32(v) for k, v in metrics.items()}

    def jax_eval_step(state, g, p, key, images=None, warmup=False):
        return {k: jnp.float32(v) for k, v in metrics.items()}

    for epoch in range(2):
        jloops.train(_Loader(batches), jax_train_step, jstate, epoch, 0,
                     False, None, writer=want, svr=True, per_step_tb=True,
                     svr_recon_fn=recon_fn("jax", True), **config)
    for epoch in range(4):
        jloops.evaluate_val(_Loader(batches), jax_eval_step, jstate, epoch,
                            False, 1e4, jnp.zeros(2, jnp.uint32), writer=want,
                            reconstruct_fn=recon_fn("jax", False), **config)

    assert got.calls == want.calls
    assert calls["port"] == calls["jax"] == (6 if logging_img else 0)
    if logging_img:
        svr_steps = sorted({s for t, s in got.calls if t.startswith("svr")})
        ae_steps = sorted({s for t, s in got.calls
                           if t.startswith("reconstruction")})
        assert svr_steps == [2, 4, 7, 9] and ae_steps == [0, 2]
        assert len(got.calls) == 4 * 4 + 2 * 4
    else:
        assert got.calls == []


# ------------------------------------------------------------------ #
# (f) open3d_utils through a stub of open3d                            #
# ------------------------------------------------------------------ #

class _FakeVector3d:
    def __init__(self, arr):
        self.arr = np.asarray(arr)


class _FakePointCloud:
    def __init__(self):
        self.points = None
        self.colors = None


class _FakeVisualizer:
    def __init__(self):
        self.calls = []
        self.geometries = []

    def create_window(self, width=None, height=None, visible=True):
        self.calls.append(("create_window", width, height, visible))

    def add_geometry(self, g):
        self.geometries.append(g)
        self.calls.append(("add_geometry",))

    def poll_events(self):
        self.calls.append(("poll_events",))

    def update_renderer(self):
        self.calls.append(("update_renderer",))

    def capture_screen_image(self, path):
        self.calls.append(("capture", path))
        with open(path, "wb") as f:
            f.write(b"png")

    def destroy_window(self):
        self.calls.append(("destroy_window",))


def _install_fake_open3d(monkeypatch):
    fake = types.ModuleType("open3d")
    fake.geometry = types.SimpleNamespace(PointCloud=_FakePointCloud)
    fake.utility = types.SimpleNamespace(Vector3dVector=_FakeVector3d)
    vis_holder = {}

    def make_vis():
        vis_holder["vis"] = _FakeVisualizer()
        return vis_holder["vis"]

    fake.visualization = types.SimpleNamespace(Visualizer=make_vis)
    monkeypatch.setitem(sys.modules, "open3d", fake)
    return vis_holder


def test_have_open3d_reflects_importability(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)
    assert not o3u.have_open3d()
    _install_fake_open3d(monkeypatch)
    assert o3u.have_open3d()


def test_cloud_to_geometry_transpose_and_palette(monkeypatch):
    _install_fake_open3d(monkeypatch)
    pts_3n = np.arange(12, dtype=np.float64).reshape(3, 4)  # (3, N)
    labels = np.array([0, 1, 2, 7])  # 7 wraps modulo the palette
    pcd = o3u.cloud_to_geometry(pts_3n, labels)
    assert pcd.points.arr.shape == (4, 3)  # transposed to (N, 3)
    np.testing.assert_array_equal(pcd.points.arr, pts_3n.T)
    np.testing.assert_array_equal(pcd.colors.arr[0], o3u._PALETTE[0])
    np.testing.assert_array_equal(pcd.colors.arr[3],
                                  o3u._PALETTE[7 % len(o3u._PALETTE)])
    # (N, 3) input passes through untransposed, no labels -> no colors
    pcd2 = o3u.cloud_to_geometry(pts_3n.T)
    np.testing.assert_array_equal(pcd2.points.arr, pts_3n.T)
    assert pcd2.colors is None
    # the same geometry as the JAX module's
    want = j_o3u.cloud_to_geometry(pts_3n, labels)
    np.testing.assert_array_equal(pcd.points.arr, want.points.arr)
    np.testing.assert_array_equal(pcd.colors.arr, want.colors.arr)


def test_capture_cloud_image_call_sequence(monkeypatch, tmp_path):
    holder = _install_fake_open3d(monkeypatch)
    out = str(tmp_path / "cloud.png")
    got = o3u.capture_cloud_image(
        np.random.RandomState(0).randn(16, 3), out, width=320, height=240
    )
    assert got == out
    vis = holder["vis"]
    names = [c[0] for c in vis.calls]
    assert names == ["create_window", "add_geometry", "poll_events",
                     "update_renderer", "capture", "destroy_window"]
    assert vis.calls[0] == ("create_window", 320, 240, False)  # off-screen
    with open(out, "rb") as f:
        assert f.read() == b"png"
