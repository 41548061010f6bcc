"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: the weights (on the device, one draw), the open-loop request
schedule and its latents, and the sample of requests that is checked.

Every seed gives the same set of request sizes and the same set of gaps
between arrivals, in another order, so the seed changes which request comes
when and what its latents are, never how much work a run offers.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _shapes(cfg: dict, discriminator: bool) -> list:
    """``(tree, leaf, shape, std)`` of every weight, generator first."""
    init = cfg["init"]
    k, z = cfg["kernel"], cfg["z_dim"]
    n0, c0, _ = cfg["layers"][0]
    out = [("g", "proj.w", (z, n0 * n0 * c0), init["proj_std"])]
    for i, (_, cin, cout) in enumerate(cfg["layers"]):
        out.append(("g", f"tconv{i}.w", (k, k, cin, cout), (k * k * cin) ** -0.5))
        out.append(("g", f"tconv{i}.b", (cout,), init["bias_std"]))
    if discriminator:
        w = cfg["discriminator_width"]
        chans = [cfg["layers"][-1][2], w, 2 * w, 4 * w]
        for i in range(3):
            out.append(("d", f"conv{i}.w", (4, 4, chans[i], chans[i + 1]),
                        (16 * chans[i]) ** -0.5))
        hw = 2 * cfg["layers"][-1][0] - k + 2 * cfg["padding"]
        out.append(("d", "head.w", ((hw // 8) ** 2 * 4 * w, 1), init["d_head_std"]))
    return out


def weights(cfg: dict, seed: int, device, *, discriminator: bool = False) -> tuple:
    """``(generator params, discriminator params or None)`` in the program's
    nested-dict layout, fp32, drawn on ``device`` from ``seed`` in one call."""
    shapes = _shapes(cfg, discriminator)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for _, _, s, _ in shapes), generator=gen,
                       device=device)
    trees = {"g": {}, "d": {} if discriminator else None}
    at = 0
    for tree, leaf, shape, std in shapes:
        n = math.prod(shape)
        mod, name = leaf.split(".")
        trees[tree].setdefault(mod, {})[name] = flat[at: at + n].reshape(shape) * std
        at += n
    return trees["g"], trees["d"]


def _counts(probs: list, n: int) -> list:
    """``n`` split by ``probs`` (largest remainders)."""
    raw = [p * n for p in probs]
    counts = [int(r) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[: n - sum(counts)]:
        counts[i] += 1
    return counts


def open_loop(mix: dict, seed: int, seconds: float) -> tuple:
    """``(sizes, arrivals_s)`` of an open loop at ``mix["rate_rps"]``
    requests a second for ``seconds``: the sizes in the mix's proportions,
    the gaps the quantiles of the exponential distribution (a Poisson
    process's), both shuffled by ``seed``; the last arrival at ``seconds``."""
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    n = max(1, round(mix["rate_rps"] * seconds))
    rng = np.random.default_rng([seed, 1])
    sizes = np.repeat(np.asarray(mix["sizes"], dtype=np.int64),
                      _counts(mix["probabilities"], n))
    rng.shuffle(sizes)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng.shuffle(gaps)
    return sizes.tolist(), np.cumsum(gaps).tolist()


def latents(sizes: list, z_dim: int, seed: int) -> list:
    """One host array of latent rows per request."""
    rng = np.random.default_rng([seed, 2])
    z = rng.standard_normal((sum(sizes), z_dim), dtype=np.float32)
    bounds = np.cumsum([0] + sizes)
    return [z[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def check_sample(sizes: list, count: int, seed: int) -> list:
    """Indices of the requests whose rows are compared: one of every size
    (the largest among them), the rest drawn at random."""
    rng = np.random.default_rng([seed, 3])
    order = rng.permutation(len(sizes)).tolist()
    picked, seen = [], set()
    for i in order:
        if sizes[i] not in seen:
            seen.add(sizes[i])
            picked.append(i)
    chosen = set(picked)
    rest = [i for i in order if i not in chosen]
    return sorted(picked + rest[: max(0, count - len(picked))])
