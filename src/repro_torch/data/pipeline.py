"""Procedural scenes for the saccade loop, generated with numpy.

``SceneStream.batch(step, n)`` is a pure function of (seed, step): the same
frames and labels as the reference's ``SceneStream`` for the same seed, so
a run can be replayed anywhere without a data file.
"""

from __future__ import annotations

import numpy as np


class SceneStream:
    """K-class shape scenes: a dark textured background and one bright
    shape (squares / discs / crosses / stripes of varying scale) at a
    random position, so classification needs localized patch features."""

    def __init__(self, seed: int = 7, image: int = 64, n_classes: int = 4):
        self.seed, self.image, self.n_classes = seed, image, n_classes

    def batch(self, step: int, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 999_983 + step)
        h = w = self.image
        imgs = rng.uniform(0.0, 0.25, size=(batch_size, h, w, 3)).astype(np.float32)
        labels = rng.integers(0, self.n_classes, size=batch_size)
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(batch_size):
            c = int(labels[i])
            size = rng.integers(h // 8, h // 4)
            cy = rng.integers(size, h - size)
            cx = rng.integers(size, w - size)
            color = rng.uniform(0.7, 1.0, size=3).astype(np.float32)
            dy, dx = yy - cy, xx - cx
            box = (np.abs(dy) < size) & (np.abs(dx) < size)
            if c == 0:      # square
                m = box
            elif c == 1:    # disc
                m = dy * dy + dx * dx < size * size
            elif c == 2:    # cross
                m = ((np.abs(dy) < size // 3) | (np.abs(dx) < size // 3)) & box
            else:           # diagonal stripes patch
                m = box & (((yy + xx) // 3) % 2 == 0)
            imgs[i][m] = color
        return imgs, labels.astype(np.int32)
