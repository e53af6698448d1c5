"""Deterministic data, generated with numpy.

``TokenStream.batch(step)`` (synthetic LM tokens) and
``SceneStream.batch(step, n)`` (procedural scenes for the saccade loop) are
pure functions of (seed, step), bitwise the reference's for the same seed,
so a run can be replayed anywhere without a data file.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8


class TokenStream:
    """Synthetic token batches: a zipf unigram mixed with a fixed first-order
    markov shift, so the loss has learnable structure. ``batch(step)`` is
    pure; ``host_id`` / ``n_hosts`` take one host's rows of the global batch."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self.unigram = 1.0 / np.arange(1, v + 1)
        self.unigram /= self.unigram.sum()
        self.shift = root.integers(1, v, size=v)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 65_537 + host_id)
        first = rng.choice(cfg.vocab, size=(per_host, 1), p=self.unigram)
        noise = rng.random((per_host, cfg.seq_len - 1))
        toks = [first[:, 0]]
        for t in range(cfg.seq_len - 1):
            nxt = np.where(
                noise[:, t] < 0.75,
                self.shift[toks[-1]],                       # learnable transition
                rng.choice(cfg.vocab, size=per_host, p=self.unigram),
            )
            toks.append(nxt)
        return {"tokens": np.stack(toks, axis=1).astype(np.int32)}


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
