"""TensorBoard reconstruction figures (counterpart of
go_with_the_flows_tpu/viz/tb.py): ground truth beside its reconstruction,
each point colored by its mixture component, after the JAX module's fixed
3-D rotation (25, 135, 0 degrees, extrinsic xyz), seen along z.

The JAX module draws matplotlib scatter figures. The port draws each
panel itself into a (PANEL, PANEL, 3) uint8 array, white, and writes the
panels side by side with `writer.add_image(tag, image, step,
dataformats="HWC")`: no plotting library is needed, and the figure has no
titles. A panel projects the rotated cloud's x to the right and y up,
one scale for both axes (matplotlib's equal aspect), its bounding box
centred with a 5% margin on each side (matplotlib's default data
margins), and paints each point as a DOT x DOT square of its color:
ground truth in label 0's grey, the reconstruction in
_PALETTE[label % 7]. SVR figures put the conditioning image first,
scaled by nearest neighbour to fit its panel.
"""

from __future__ import annotations

import math

import numpy as np

_PALETTE = np.array([
    [0.35, 0.35, 0.35],   # label 0 (unlabeled / GT)
    [0.894, 0.102, 0.110],
    [0.216, 0.494, 0.722],
    [0.302, 0.686, 0.290],
    [0.596, 0.306, 0.639],
    [1.000, 0.498, 0.000],
    [0.651, 0.337, 0.157],
], dtype=np.float32)

ANGLES = (25.0, 135.0, 0.0)
PANEL = 256        # a panel's height and width, in pixels
DOT = 2            # a point's square, in pixels
BACKGROUND = 255   # white
MARGIN = 0.05      # of the cloud's extent, on each side


def _rotate(points: np.ndarray, angles=ANGLES) -> np.ndarray:
    """Apply the fixed viewing rotation; points are (3, N). Extrinsic
    rotations about x, then y, then z by `angles` in degrees, as the JAX
    module's scipy Rotation.from_euler("xyz", ...)."""
    a, b, c = (math.radians(t) for t in angles)
    rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                   [0, math.sin(a), math.cos(a)]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0],
                   [-math.sin(b), 0, math.cos(b)]])
    rz = np.array([[math.cos(c), -math.sin(c), 0],
                   [math.sin(c), math.cos(c), 0], [0, 0, 1]])
    return rz @ ry @ rx @ np.asarray(points, np.float64)


def project(cloud: np.ndarray, size: int = PANEL):
    """(rows, cols): the top-left pixel of each point's dot in a panel of
    size x size pixels, for a (3, N) cloud."""
    xy = _rotate(cloud)[:2]
    lo, hi = xy.min(axis=1), xy.max(axis=1)
    centre = (lo + hi) / 2.0
    span = max(float((hi - lo).max()), 1e-12) * (1.0 + 2.0 * MARGIN)
    last = size - DOT  # the dot's last pixel stays in the panel
    cols = np.floor((0.5 + (xy[0] - centre[0]) / span) * last)
    rows = np.floor((0.5 - (xy[1] - centre[1]) / span) * last)
    return (np.clip(rows, 0, last).astype(np.int64),
            np.clip(cols, 0, last).astype(np.int64))


def _colors(labels) -> np.ndarray:
    rgb = _PALETTE[np.asarray(labels).astype(int) % len(_PALETTE)]
    return np.round(rgb * 255.0).astype(np.uint8)


def cloud_panel(cloud: np.ndarray, labels, size: int = PANEL) -> np.ndarray:
    """A (size, size, 3) uint8 panel of a (3, N) cloud, its points
    painted in order by their labels' colors."""
    rows, cols = project(cloud, size)
    # each pixel takes the color of the last point whose dot covers it
    last = np.full(size * size, -1, np.int64)
    order = np.arange(rows.shape[0])
    for dr in range(DOT):
        for dc in range(DOT):
            np.maximum.at(last, (rows + dr) * size + cols + dc, order)
    panel = np.full((size * size, 3), BACKGROUND, np.uint8)
    hit = last >= 0
    panel[hit] = _colors(labels)[last[hit]]
    return panel.reshape(size, size, 3)


def image_panel(image: np.ndarray, size: int = PANEL) -> np.ndarray:
    """A (size, size, 3) uint8 panel of a (C, H, W) conditioning image
    (the port's layout): channels 1-3 when it has 4 or more, else 0-2,
    as the JAX module takes them, clipped to [0, 1] and scaled by
    nearest neighbour to fit, centred."""
    image = np.asarray(image, np.float32)
    rgb = image[1:4] if image.shape[0] >= 4 else image[:3]
    rgb = np.clip(rgb, 0.0, 1.0).transpose(1, 2, 0)
    h, w = rgb.shape[:2]
    scale = min(size / h, size / w)
    out_h, out_w = max(int(h * scale), 1), max(int(w * scale), 1)
    rows = np.minimum((np.arange(out_h) / scale).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(out_w) / scale).astype(np.int64), w - 1)
    panel = np.full((size, size, 3), BACKGROUND, np.uint8)
    top, left = (size - out_h) // 2, (size - out_w) // 2
    panel[top:top + out_h, left:left + out_w] = np.round(
        rgb[rows][:, cols] * 255.0).astype(np.uint8)
    return panel


def reconstruction_figure(gt, recon, labels) -> np.ndarray:
    """(PANEL, 2 PANEL, 3) uint8: the ground truth (3, N') in grey, the
    reconstruction (3, N) colored by its labels (N,)."""
    gt = np.asarray(gt)
    return np.concatenate([cloud_panel(gt, np.zeros(gt.shape[1], int)),
                           cloud_panel(np.asarray(recon), labels)], axis=1)


def add_figures_reconstruction_tb(gts, samples, labels, writer, epoch: int,
                                  max_figures: int = 4):
    """Write ground-truth-vs-reconstruction figures of the first
    `max_figures` clouds as images `reconstruction/{i}` at step `epoch`
    (the reference's visualization/utils.py:41-51)."""
    for i in range(min(len(gts), max_figures)):
        writer.add_image(f"reconstruction/{i}",
                         reconstruction_figure(gts[i], samples[i],
                                               labels[i]),
                         epoch, dataformats="HWC")


def add_svr_reconstruction_tb(images, gts, samples, labels, writer,
                              epoch: int, max_figures: int = 4):
    """Write SVR figures, the conditioning image (C, H, W) before the
    ground truth and the reconstruction, as images
    `svr_reconstruction/{i}` at step `epoch` (the reference's
    visualization/utils.py:52-61)."""
    for i in range(min(len(gts), max_figures)):
        figure = np.concatenate(
            [image_panel(images[i]),
             reconstruction_figure(gts[i], samples[i], labels[i])], axis=1)
        writer.add_image(f"svr_reconstruction/{i}", figure, epoch,
                         dataformats="HWC")
