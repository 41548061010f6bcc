"""Train, eval and serve steps. Mirrors ``repro/train/train_step.py``.

``make_train_step`` builds the reference's fused step:

    grads = grad(loss)(params, batch)
    [optional int8 quantize -> dequantize of every gradient, where the
     reference places it around its cross-pod all-reduce]
    params, opt_state = adamw(grads, ..., cosine lr from opt_state["count"])

The step reads nothing back to the host and writes into none of its
inputs, so :class:`repro_torch.train.trainer.Trainer` captures it whole as
one CUDA graph and can keep the old state when a step is not finite.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_int8,
    cosine_schedule,
    decompress_int8,
)
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False  # int8 gradient compression (cross-pod DP)


def init_train_state(model, generator, train_cfg: TrainConfig, device=None):
    """``(params, opt_state)``: ``model.init(generator, device)`` (``None``
    means the CUDA card) and zero AdamW moments beside them."""
    params = model.init(generator, device=device)
    return params, adamw_init(params, train_cfg.optimizer)


def abstract_train_state(model, train_cfg: TrainConfig):
    """The train state as meta tensors: shapes and dtypes, no storage."""
    return init_train_state(model, None, train_cfg, device="meta")


def _qdq(g: torch.Tensor) -> torch.Tensor:
    q, s = compress_int8(g)
    return decompress_int8(q, s, tuple(g.shape)).to(g.dtype)


def make_train_step(model, train_cfg: TrainConfig, *, plan=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``metrics`` ``{"loss", "grad_norm", "lr", "ce", "aux"}``,
    each an fp32 scalar on the params' device. ``plan=`` is passed to
    ``model.loss`` only when given, as the reference does."""
    opt_cfg = train_cfg.optimizer

    def loss_fn(params, batch):
        if plan is None:
            return model.loss(params, batch)
        return model.loss(params, batch, plan=plan)

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, metrics = loss_fn(live, batch)
            flat = torch.autograd.grad(loss, tree_leaves(live))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), live)
        if train_cfg.compress_grads:
            grads = tree_map(_qdq, grads)
        lr_t = cosine_schedule(opt_state["count"], base_lr=opt_cfg.lr,
                               warmup_steps=train_cfg.warmup_steps,
                               total_steps=train_cfg.total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg,
                                                lr_t)
        out = {"loss": loss.detach().float(), "grad_norm": gnorm, "lr": lr_t,
               **{k: v.detach().float() for k, v in metrics.items()}}
        return params, opt_state, out

    return train_step


def make_eval_step(model, *, plan=None):
    @torch.no_grad()
    def eval_step(params, batch):
        if plan is not None:
            loss, metrics = model.loss(params, batch, plan=plan)
        else:
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(model):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model):
    @torch.no_grad()
    def serve_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return serve_step
