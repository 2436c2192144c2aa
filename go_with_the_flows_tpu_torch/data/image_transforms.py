"""Image transformations for the SVR pipeline on the host, numpy (the
port's copy of go_with_the_flows_tpu/data/image_transforms.py).

Behaviour port of the reference's `lib/datasets/image_transformations.py`.
Input images are uint8 (4, H, W) RGBA renderings (reference
preprocess_ShapeNetAll.py:65-78); the composed pipeline gives float32
(C, H, W), which the port's model takes as it is (NCHW).

`Resize` is cv2's INTER_LINEAR on float32, written without cv2 (the
card's machine has none): two interpolation matrices an image size,
out_c = R_y @ img_c @ R_x^T.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cloud_transforms import Compose


class ToFloat:
    """uint8 -> [0,1] float with alpha premultiplied into R,G
    (reference ToNumpy, image_transformations.py:7-14 — including its
    quirk of multiplying channels 0..1 by channel 2)."""

    def __call__(self, image):
        img = np.float32(image / 255.0)
        img[:2] = np.expand_dims(img[2], 0) * img[:2]
        return img


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres, src = (dst + 0.5) * n_in / n_out - 0.5, each
    output a blend of the two nearest inputs, edges clamped, no
    antialiasing when shrinking."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    low = x0 < 0
    x0[low], frac[low] = 0, 0.0
    high = x0 >= n_in - 1
    x0[high], frac[high] = n_in - 1, 0.0
    x1 = np.minimum(x0 + 1, n_in - 1)
    weights = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(weights, (rows, x0), 1.0 - frac)
    np.add.at(weights, (rows, x1), frac)
    return weights.astype(np.float32)


class Resize:
    """Bilinear resize of a (C, H, W) float image to `image_size`, given
    as (width, height) like cv2's dsize."""

    def __init__(self, **kwargs):
        self.size = kwargs.get("image_size")
        self._matrices = {}

    def _matrix(self, n_in: int, n_out: int) -> np.ndarray:
        key = (n_in, n_out)
        if key not in self._matrices:  # a racing thread writes the same
            self._matrices[key] = linear_resize_matrix(n_in, n_out)
        return self._matrices[key]

    def __call__(self, image):
        image = np.asarray(image, np.float32)
        width, height = self.size[0], self.size[1]
        r_y = self._matrix(image.shape[1], height)
        r_x = self._matrix(image.shape[2], width)
        return np.matmul(np.matmul(r_y, image), r_x.T)


class Pad:
    def __init__(self, **kwargs):
        self.pad_size = kwargs.get("image_pad_size")

    def __call__(self, image):
        ph, pw = self.pad_size
        padded = np.zeros(
            (image.shape[0], image.shape[1] + 2 * ph, image.shape[2] + 2 * pw),
            dtype=np.float32,
        )
        padded[:, ph:-ph, pw:-pw] = image
        return padded


class AddGrayscale:
    """Prepend a luma channel (0.299R + 0.587G + 0.114B) -> 4+ channels
    (image_transformations.py:40-48); with RemoveAlpha this yields the
    model's 4-channel input (gray, R, G, B)."""

    def __call__(self, image):
        luma = 0.299 * image[0] + 0.587 * image[1] + 0.114 * image[2]
        return np.vstack((np.expand_dims(luma, 0), image))


class NormalizeImages:
    def __init__(self, **kwargs):
        self.mean = np.asarray(kwargs.get("image_means"), np.float32)
        self.std = np.asarray(kwargs.get("image_stds"), np.float32)

    def __call__(self, image):
        return (image - self.mean.reshape(-1, 1, 1)) / self.std.reshape(
            -1, 1, 1
        )


class AddNoise2Images:
    def __init__(self, rng: Optional[np.random.Generator] = None, **kwargs):
        self.scale = kwargs.get("image_noise_scale")
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, image):
        noise = np.float32(self.rng.normal(scale=self.scale, size=image.shape))
        return np.clip(image + noise, 0.0, 1.0)


class RemoveAlpha:
    def __call__(self, image):
        return image[:4]


def ComposeImageTransformation(**kwargs):
    """Build the image pipeline from config flags
    (image_transformations.py:76-95).

    Order fix vs the reference: its composer normalizes BEFORE RemoveAlpha,
    but AddGrayscale has produced 5 channels (gray,R,G,B,A) while the
    config supplies 4 means/stds — that order cannot execute
    (broadcast error). The intended 4-channel model input is
    (gray, R, G, B), so RemoveAlpha runs right after AddGrayscale and
    normalization sees exactly 4 channels.
    """
    ts = [ToFloat()]
    if kwargs.get("image_resize"):
        ts.append(Resize(**kwargs))
    if kwargs.get("image_pad"):
        ts.append(Pad(**kwargs))
    if kwargs.get("image_add_grayscale"):
        ts.append(AddGrayscale())
    if kwargs.get("image_remove_alpha"):
        ts.append(RemoveAlpha())
    if kwargs.get("image_normalize"):
        ts.append(NormalizeImages(**kwargs))
    if kwargs.get("image_noise"):
        ts.append(AddNoise2Images(**kwargs))
    return Compose(ts)
