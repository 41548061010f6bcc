"""Load the reference package's parameters and training state into the
port.

The JAX generator's parameters are a pytree ``{"proj": {"w"}, "tconv{i}":
{"w", "b"}}``; handed over as numpy arrays, they become the port's dict of
tensors with every layout kept: ``proj.w`` stays ``(z_dim, h0*h0*c0)``
(its product reshapes to NHWC in both packages) and kernels stay HWIO. Both
packages then compute the same function. :func:`from_jax_state` does the
same for the reference trainer's whole state (both nets and both optimizer
states), so both packages can start a step from one state.
:func:`from_jax_lm_params` and :func:`from_jax_lm_cache` carry the
reference LM's parameters (per-period stacking kept; an encoder-decoder's
``{"encoder", "decoder"}`` tree too) and its serving cache over the same
way.
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


def from_jax_lm_params(params_np: dict, cfg, device) -> dict:
    """The port LM's parameters from numpy copies of the reference LM's for
    config ``cfg`` (bfloat16 arrays carried by their bits), each leaf in the
    dtype the port's layout gives it (an fp32 array for a bf16 leaf is
    rounded to nearest even), on ``device`` (``None`` means the CUDA card).
    Raises ``ValueError`` on a missing leaf or a shape that does not match
    ``cfg``."""
    from repro_torch.models.lm import build_model

    dev = resolve_device(device)

    def leaf(want, a, path):
        if tuple(np.shape(a)) != tuple(want.shape):
            raise ValueError(f"{path} has shape {tuple(np.shape(a))}, want "
                             f"{tuple(want.shape)}")
        return _tensor(a, dev).to(want.dtype)

    def walk(shapes, tree, path):
        if tree is None:
            raise ValueError(f"missing parameter {path}")
        if isinstance(shapes, dict):
            if not isinstance(tree, dict):
                raise ValueError(f"{path or 'params'} is not a dict")
            return {k: walk(v, tree.get(k), f"{path}.{k}" if path else k)
                    for k, v in shapes.items()}
        if isinstance(shapes, list):
            if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
                raise ValueError(f"{path} must hold {len(shapes)} period positions")
            return [walk(s, t, f"{path}[{i}]") for i, (s, t) in enumerate(zip(shapes, tree))]
        return leaf(shapes, tree, path)

    return walk(build_model(cfg).abstract_params(), params_np, "")


_STATE_KEYS = ({"conv", "ssm"}, {"C", "n", "m"}, {"c", "n", "h", "m"})


def from_jax_lm_cache(cache_np, device):
    """The port LM's serving cache from numpy copies of the reference's, on
    ``device`` (``None`` means the CUDA card): for a decoder-only LM a
    sequence (per period position) of entries stacked over periods, each a
    ``(k, v)`` pair ``(n_periods, B, S, KV, hd)`` (a KVCache) or a dict of
    recurrent state arrays (Mamba ``conv``/``ssm``, mLSTM ``C``/``n``/``m``,
    sLSTM ``c``/``n``/``h``/``m``); for an encoder-decoder a dict of
    ``"self"`` and ``"cross"`` pairs ``(n_layers, B, S, KV, hd)``. Raises
    ``ValueError`` on any other entry."""
    from repro_torch.models.layers import KVCache

    dev = resolve_device(device)

    def kv(pair):
        k, v = pair
        if np.shape(k) != np.shape(v) or np.ndim(k) != 5:
            raise ValueError(f"expected k and v (n_periods, B, S, KV, hd), got "
                             f"{np.shape(k)} and {np.shape(v)}")
        return KVCache(_tensor(k, dev), _tensor(v, dev))

    def entry(e):
        if isinstance(e, dict):
            if set(e) not in _STATE_KEYS:
                raise ValueError(f"unknown recurrent state keys {sorted(e)}")
            return {k: _tensor(a, dev) for k, a in e.items()}
        return kv(e)

    if isinstance(cache_np, dict):
        if set(cache_np) != {"self", "cross"}:
            raise ValueError(f"an encoder-decoder cache holds self and cross, not "
                             f"{sorted(cache_np)}")
        return {name: kv(cache_np[name]) for name in ("self", "cross")}
    return [entry(e) for e in cache_np]
