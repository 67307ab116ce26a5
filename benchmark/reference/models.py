"""Plain float32 models of the benchmark's configurations, one member at a time.

Written from the configuration files and the published descriptions, in
plain ``torch`` operations, with no kernel, folding or batching of the
program under test:

- ``smallcnn``: four 3x3 SAME convolutions with bias (widths w, w, 2w,
  2w), each followed by GroupNorm and ReLU, a 2x2 stride-2 max-pool after
  the second and the fourth, the activations flattened in H, W, C order,
  a dense layer with ReLU and the output layer.
- ``resnet18``: ResNet-18 for CIFAR (He et al., arXiv:1512.03385): a 3x3
  stem without max-pool, four stages of two basic blocks at widths
  64-128-256-512, a 1x1 projection where the shape changes, global
  average pooling and one dense layer. Departure from the paper: every
  BatchNorm is a GroupNorm of ``min(32, channels)`` groups, as in the
  configuration. Strided convolutions pad as XLA's "SAME" does (the 3x3
  stride-2 one pads one row and column at the bottom and right only).

Parameters are named and shaped as one member's slice of a population
(``conv0.weight`` ``[Cout, Cin, k, k]``, ``fc1.weight`` ``[out, in]``),
so the initial draws (``reference/replay.py``) can be made at the
population's shapes and sliced.

``q`` is the rounding applied where the configuration computes in a
lower precision than the parameters: the identity for the float32
reference, and a scaled float8 round trip for the control
(``reference/precision.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride, q):
    """SAME convolution of NCHW ``x``, rounded by ``q`` on the way in
    and out."""
    k = w.shape[-1]
    (ht, hb), (wl, wr) = (_same_pad(s, k, stride) for s in x.shape[2:])
    x = F.pad(q(x), (wl, wr, ht, hb))
    return q(F.conv2d(x, q(w), None if b is None else q(b), stride=stride))


def group_norm(x, groups, gamma, beta, eps, relu, q):
    y = F.group_norm(x, groups, gamma, beta, eps)
    return q(F.relu(y) if relu else y)


def dense(x, w, b, q):
    return q(F.linear(q(x), q(w), q(b)))


def layer_shapes(cfg: dict) -> list:
    """(name, shape, kind) of one member's parameters in the order the
    model's layers are initialised; kind is ``conv``/``dense`` (a
    truncated-normal weight), ``zeros`` or ``ones``."""
    out = []
    if cfg["model"] == "smallcnn":
        w, cin = cfg["width"], cfg["channels"]
        for i, ch in enumerate((w, w, 2 * w, 2 * w)):
            out += [(f"conv{i}.weight", (ch, cin, 3, 3), "conv"), (f"conv{i}.bias", (ch,), "zeros"),
                    (f"gn{i}.gamma", (ch,), "ones"), (f"gn{i}.beta", (ch,), "zeros")]
            cin = ch
        side = cfg["image_size"] // 4
        out += [("fc1.weight", (cfg["dense"], side * side * cin), "dense"),
                ("fc1.bias", (cfg["dense"],), "zeros"),
                ("fc2.weight", (cfg["n_classes"], cfg["dense"]), "dense"),
                ("fc2.bias", (cfg["n_classes"],), "zeros")]
        return out
    if cfg["model"] == "resnet18":
        w = cfg["width"]
        out += [("stem.weight", (w, cfg["channels"], 3, 3), "conv"),
                ("gn_stem.gamma", (w,), "ones"), ("gn_stem.beta", (w,), "zeros")]
        cin = w
        for stage, n_blocks in enumerate(cfg["stage_sizes"]):
            ch = w * 2**stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                p = f"stage{stage}_block{b}"
                out += [(f"{p}.conv1.weight", (ch, cin, 3, 3), "conv"),
                        (f"{p}.gn1.gamma", (ch,), "ones"), (f"{p}.gn1.beta", (ch,), "zeros"),
                        (f"{p}.conv2.weight", (ch, ch, 3, 3), "conv"),
                        (f"{p}.gn2.gamma", (ch,), "ones"), (f"{p}.gn2.beta", (ch,), "zeros")]
                if cin != ch or stride != 1:
                    out += [(f"{p}.proj.weight", (ch, cin, 1, 1), "conv"),
                            (f"{p}.gn_proj.gamma", (ch,), "ones"),
                            (f"{p}.gn_proj.beta", (ch,), "zeros")]
                cin = ch
        out += [("head.weight", (cfg["n_classes"], cin), "dense"),
                ("head.bias", (cfg["n_classes"],), "zeros")]
        return out
    raise ValueError(f"unknown model {cfg['model']!r}")


def gn_groups(cfg: dict, ch: int) -> int:
    """GroupNorm groups of a ``ch``-channel layer."""
    return cfg["gn_groups"] if cfg["model"] == "smallcnn" else min(cfg["gn_groups"], ch)


def forward(cfg: dict, p: dict, x: torch.Tensor, q) -> torch.Tensor:
    """One member's logits ``[B, n_classes]`` (float32) of NHWC images."""
    eps = cfg["gn_eps"]
    x = x.permute(0, 3, 1, 2)
    if cfg["model"] == "smallcnn":
        for i in range(4):
            x = conv(x, p[f"conv{i}.weight"], p[f"conv{i}.bias"], 1, q)
            x = group_norm(x, cfg["gn_groups"], p[f"gn{i}.gamma"], p[f"gn{i}.beta"], eps, True, q)
            if i % 2 == 1:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(dense(x, p["fc1.weight"], p["fc1.bias"], q))
        return dense(x, p["fc2.weight"], p["fc2.bias"], q).float()
    w = cfg["width"]
    x = conv(x, p["stem.weight"], None, 1, q)
    x = group_norm(x, gn_groups(cfg, w), p["gn_stem.gamma"], p["gn_stem.beta"], eps, True, q)
    cin = w
    for stage, n_blocks in enumerate(cfg["stage_sizes"]):
        ch = w * 2**stage
        g = gn_groups(cfg, ch)
        for b in range(n_blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            pre = f"stage{stage}_block{b}"
            y = conv(x, p[f"{pre}.conv1.weight"], None, stride, q)
            y = group_norm(y, g, p[f"{pre}.gn1.gamma"], p[f"{pre}.gn1.beta"], eps, True, q)
            y = conv(y, p[f"{pre}.conv2.weight"], None, 1, q)
            y = group_norm(y, g, p[f"{pre}.gn2.gamma"], p[f"{pre}.gn2.beta"], eps, False, q)
            if cin != ch or stride != 1:
                x = conv(x, p[f"{pre}.proj.weight"], None, stride, q)
                x = group_norm(x, g, p[f"{pre}.gn_proj.gamma"], p[f"{pre}.gn_proj.beta"], eps, False, q)
            x = q(F.relu(x + y))
            cin = ch
    x = q(x.mean(dim=(2, 3)))
    return dense(x, p["head.weight"], p["head.bias"], q).float()


def gn_sites(cfg: dict) -> list:
    """(rows S per image, channels C, relu) of every GroupNorm of one
    member's forward pass (the shapes ``reference/counts.py`` reads)."""
    side = cfg["image_size"]
    out = []
    if cfg["model"] == "smallcnn":
        w = cfg["width"]
        for i, ch in enumerate((w, w, 2 * w, 2 * w)):
            s = side // (2 if i >= 2 else 1)
            out.append((s * s, ch, True))
        return out
    w = cfg["width"]
    out.append((side * side, w, True))
    cin, s = w, side
    for stage, n_blocks in enumerate(cfg["stage_sizes"]):
        ch = w * 2**stage
        for b in range(n_blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            s = -(-s // stride)
            out += [(s * s, ch, True), (s * s, ch, False)]
            if cin != ch or stride != 1:
                out.append((s * s, ch, False))
            cin = ch
    return out
