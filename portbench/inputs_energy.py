"""The energy configuration's weights, made from ``--seed`` and handed to
both the program and the reference: the generator with its RGB head and
the auto-encoder, drawn on the device in one call, in the program's
nested-dict layout (``portbench/inputs.py`` draws the classifier
configuration's)."""
from __future__ import annotations

import math

import torch


def shapes(cfg: dict) -> list:
    """``(tree, path, shape, std)`` of every weight, generator first, in
    the order of the draw; ``path`` is the leaf's dotted key path."""
    k, z, bias = cfg["kernel"], cfg["z_dim"], cfg["init"]["bias_std"]
    n0, c0, _ = cfg["layers"][0]
    out = [("g", "proj.w", (z, n0 * n0 * c0), (2.0 / z) ** 0.5)]
    for i, (_, cin, cout) in enumerate(cfg["layers"]):
        out.append(("g", f"tconv{i}.w", (k, k, cin, cout), (2 * cin) ** -0.5))
        out.append(("g", f"tconv{i}.b", (cout,), bias))
    c_last, head = cfg["layers"][-1][2], cfg["rgb_head"]
    out.append(("g", "head.w", (c_last, head), c_last ** -0.5))
    out.append(("g", "head.b", (head,), bias))
    chans = [head] + list(cfg["encoder_widths"])
    for i in range(len(chans) - 1):
        out.append(("d", f"enc{i}.w", (4, 4, chans[i], chans[i + 1]), (8 * chans[i]) ** -0.5))
    back = chans[::-1]
    for i in range(len(back) - 1):
        out.append(("d", f"dec.tconv{i}.w", (k, k, back[i], back[i + 1]),
                    (2 * back[i]) ** -0.5))
        out.append(("d", f"dec.tconv{i}.b", (back[i + 1],), bias))
    return out


def weights(cfg: dict, seed: int, device) -> tuple:
    """``(generator params, auto-encoder params)``, fp32, drawn on
    ``device`` from ``seed`` in one call."""
    spec = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, _, s, _ in spec), generator=gen,
                       device=device)
    trees = {"g": {}, "d": {}}
    at = 0
    for tree, path, shape, std in spec:
        n = math.prod(shape)
        *mods, leaf = path.split(".")
        node = trees[tree]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = flat[at: at + n].reshape(shape) * std
        at += n
    return trees["g"], trees["d"]
