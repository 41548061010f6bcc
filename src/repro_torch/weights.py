"""Load the reference package's generator parameters into the port.

The JAX generator's parameters are a pytree ``{"proj": {"w"}, "tconv{i}":
{"w", "b"}}``; handed over as numpy arrays, they become the port's dict of
tensors with every layout kept: ``proj.w`` stays ``(z_dim, h0*h0*c0)``
(its product reshapes to NHWC in both packages) and kernels stay HWIO. Both
packages then compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax_params(params_np: dict, cfg, device) -> dict:
    """Port parameters (float32, on ``device``) from numpy copies of the
    reference's generator parameters for config ``cfg``. ``device=None``
    means the CUDA card. Raises ``ValueError`` on a shape that does not
    match ``cfg``."""
    dev = resolve_device(device)
    h0, c0, _ = cfg.layers[0]
    want = {("proj", "w"): (cfg.z_dim, h0 * h0 * c0)}
    for i, (_, cin, cout) in enumerate(cfg.layers):
        want[(f"tconv{i}", "w")] = (cfg.kernel, cfg.kernel, cin, cout)
        want[(f"tconv{i}", "b")] = (cout,)
    out: dict = {}
    for (layer, name), shape in want.items():
        a = np.asarray(params_np[layer][name], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{layer}.{name} has shape {a.shape}, want {shape}")
        out.setdefault(layer, {})[name] = torch.from_numpy(a.copy()).to(dev)
    return out
