"""Load the reference package's parameters and training state into the
port.

The JAX generator's parameters are a pytree ``{"proj": {"w"}, "tconv{i}":
{"w", "b"}}``; handed over as numpy arrays, they become the port's dict of
tensors with every layout kept: ``proj.w`` stays ``(z_dim, h0*h0*c0)``
(its product reshapes to NHWC in both packages) and kernels stay HWIO. Both
packages then compute the same function. :func:`from_jax_state` does the
same for the reference trainer's whole state (both nets and both optimizer
states), so both packages can start a step from one state.
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


def _tensor(a, dev) -> torch.Tensor:
    """A numpy array (bfloat16 ones by their bits: the port does not use
    ``ml_dtypes``) as a tensor on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def from_jax_state(state_np: dict, cfg, device) -> dict:
    """The port trainer's state from numpy copies of the reference
    trainer's ``{"g_params", "d_params", "g_opt", "d_opt"}`` (optimizer
    moments of any dtype, the step count, and the error-feedback trees when
    present), on ``device`` (``None`` means the CUDA card)."""
    dev = resolve_device(device)
    return {
        "g_params": from_jax_params(state_np["g_params"], cfg, dev),
        "d_params": _tree(state_np["d_params"], dev),
        "g_opt": _tree(state_np["g_opt"], dev),
        "d_opt": _tree(state_np["d_opt"], dev),
    }
