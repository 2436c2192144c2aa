"""Cloud transformations on the host, numpy (the port's copy of
go_with_the_flows_tpu/data/cloud_transforms.py).

Behaviour port of the reference's `lib/datasets/cloud_transformations.py`
with its two known bugs fixed, as in the JAX package: Random3DRotation
referenced `Rotation` without importing it and rotated `cloud` into
`eval_cloud` (cloud_transformations.py:70-74); here both clouds get the
same rotation, each applied to its own points. Transforms operate on
sample dicts with (3, N) clouds. scipy is imported only by
Random3DRotation, which neither the flagship nor the SVR config uses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def _apply_both(sample, fn):
    sample["cloud"] = fn(sample["cloud"])
    if "eval_cloud" in sample:
        sample["eval_cloud"] = fn(sample["eval_cloud"])
    return sample


class Scale2OrigCloud:
    """Rescale/recenter back to the original mesh frame
    (cloud_transformations.py:6-20)."""

    def __init__(self, **kwargs):
        self.do_rescale = kwargs["cloud_rescale2orig"]
        self.do_recenter = kwargs["cloud_recenter2orig"]

    def __call__(self, sample):
        if self.do_rescale:
            sample = _apply_both(sample, lambda c: sample["orig_s"] * c)
        if self.do_recenter:
            shift = sample["orig_c"].reshape(-1, 1)
            sample = _apply_both(sample, lambda c: c + shift)
        return sample


class TranslateCloud:
    def __init__(self, **kwargs):
        self.shift = np.asarray(
            kwargs["cloud_translate_shift"], np.float32
        ).reshape(-1, 1)

    def __call__(self, sample):
        return _apply_both(sample, lambda c: c - self.shift)


class ScaleCloud:
    """Divide by cloud_scale_scale — the active coordinate-frame transform
    in every published config (cloud / 2.0; cloud_transformations.py:34-42).
    """

    def __init__(self, **kwargs):
        self.scale = np.float32(kwargs.get("cloud_scale_scale"))

    def __call__(self, sample):
        return _apply_both(sample, lambda c: c / self.scale)


class AddNoise2Cloud:
    def __init__(self, rng: Optional[np.random.Generator] = None, **kwargs):
        self.scale = np.float32(kwargs.get("cloud_noise_scale"))
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, sample):
        return _apply_both(
            sample,
            lambda c: c + self.rng.normal(
                scale=self.scale, size=c.shape
            ).astype(np.float32),
        )


class CenterCloud:
    def __call__(self, sample):
        return _apply_both(sample, lambda c: c - c.mean(1, keepdims=True))


class Random3DRotation:
    """Random SO(3) rotation of both clouds + euler angles in the sample.
    (Fixes the reference's missing import and cloud/eval_cloud mixup.)"""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else np.random.default_rng()

    def __call__(self, sample):
        from scipy.spatial.transform import Rotation

        rot = Rotation.random(random_state=self.rng)
        sample = _apply_both(
            sample, lambda c: rot.apply(c.T).T.astype(np.float32)
        )
        sample["rotation"] = np.tile(
            rot.as_euler("zxy", degrees=False), (1, 1)
        ).astype(np.float32)
        return sample


def ComposeCloudTransformation(**kwargs):
    """Build (train_transform, val_transform) from config flags
    (cloud_transformations.py:79-103). Random rotation is train-only."""
    train, val = [], []

    def both(t):
        train.append(t)
        val.append(t)

    if kwargs.get("cloud_rescale2orig") or kwargs.get("cloud_recenter2orig"):
        both(Scale2OrigCloud(**kwargs))
    if kwargs.get("cloud_translate"):
        both(TranslateCloud(**kwargs))
    if kwargs.get("cloud_scale"):
        both(ScaleCloud(**kwargs))
    if kwargs.get("cloud_noise"):
        both(AddNoise2Cloud(**kwargs))
    if kwargs.get("cloud_center"):
        both(CenterCloud())
    if kwargs.get("cloud_random_rotate"):
        train.append(Random3DRotation())

    if not train:
        return None, None
    return Compose(train), Compose(val)
