"""Synthetic image classification data, made on the device from the seed.

The recipe of the synthetic CIFAR sets the program ships, frozen here:
each class has a smooth template (coarse Gaussian noise upsampled
bilinearly) over a shared background, each image is one of ``protos``
prototypes of its class plus pixel noise and a brightness jitter, and
each split is normalised to mean 0 and standard deviation 1. The draws
are torch's, on the run's device, in a few large calls; the same seed
gives the same arrays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_images(cfg: dict, seed: int, device) -> dict:
    """``train_x``/``val_x`` float32 ``[N, H, W, C]`` and ``train_y``/
    ``val_y`` int32 ``[N]`` on ``device``."""
    d = cfg["data"]
    h = w = cfg["image_size"]
    c, k, protos, coarse = cfg["channels"], cfg["n_classes"], d["protos"], d["coarse"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def smooth(n):
        z = torch.randn((n, c, coarse, coarse), generator=g, device=device)
        return F.interpolate(z, size=(h, w), mode="bilinear", align_corners=True).permute(0, 2, 3, 1)

    common = smooth(1)
    templates = (common[:, None] + d["delta"] * smooth(k)[:, None]
                 + 0.5 * smooth(k * protos).reshape(k, protos, h, w, c))

    def split(n):
        y = torch.randint(0, k, (n,), generator=g, device=device)
        p = torch.randint(0, protos, (n,), generator=g, device=device)
        x = templates[y, p]
        x += d["noise"] * torch.randn(x.shape, generator=g, device=device)
        x *= 1.0 + 0.1 * torch.randn((n, 1, 1, 1), generator=g, device=device)
        x = (x - x.mean()) / (x.std() + 1e-8)
        return x.contiguous(), y.to(torch.int32)

    train_x, train_y = split(cfg["n_train"])
    val_x, val_y = split(cfg["n_val"])
    return {"train_x": train_x, "train_y": train_y, "val_x": val_x, "val_y": val_y}
