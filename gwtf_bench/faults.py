"""Faults planted under the training loop, to show that the output check
catches them: each wraps the program's train step (`hooks["step"]` of a
kind's run)."""

from __future__ import annotations


def unchanged(step, model, optimizer):
    """A step that computes its loss and leaves the state as it was."""
    optimizer.step = lambda closure=None: None
    return step


def half_batch(step, model, optimizer):
    """A step over the first half of the batch, its mean over those rows."""
    def faulty(g, p, generator=None, warmup=False, images=None, **kw):
        h = g.shape[0] // 2
        if images is not None:
            images = images[:h]
        return step(g[:h], p[:h], generator, warmup=warmup, images=images,
                    **kw)
    return faulty
