"""Continuous-batching serving engine over the KV-cache decode step.
Mirrors ``repro/serve/engine.py``.

A fixed pool of B slots shares one decode step. Requests are admitted into
free slots as they arrive; each slot tracks its own position, so sequences
of different lengths decode in the same batched step (per-sequence ``pos``
and ``kv_len`` masking). A prompt is fed token by token through the decode
step. Finished slots are recycled without touching the others' cache rows;
an idle slot runs through the step with token 0 at its stale position, as
in the reference, and its KV rows are masked by ``kv_len`` once it is
reused. A recurrent state (Mamba's ``conv`` and ``ssm``, xLSTM's ``C``,
``n``, ``m``, ``c``, ``h``) has no such mask, so admitting a request zeroes
its slot's rows of every recurrent state, in place; the reference does
not, and there a request served in a used slot starts from the state its
slot was left in. Every step's attention runs the hand-written
flash-decode kernel on the card
(:mod:`repro_torch.kernels.decode_attention`).

On the card the decode step is one CUDA graph (:mod:`repro_torch.graphs`),
the counterpart of the reference's ``jax.jit(model.decode_step)``,
captured at construction over the engine's parameters and cache (by
address) at its fixed ``slots`` and ``max_len``: each step copies the
tokens and positions into the graph's static inputs and replays; the cache
is written in place and the logits are the graph's static ``(B, 1, V)``
buffer, which the next step overwrites (the sampler copies what it reads
to the host first). On the CPU the step runs eagerly.

Over placed parameters (``DTensor``s,
:func:`~repro_torch.distributed.sharding.distribute_params`) the engine's
caches are placed by :func:`~repro_torch.distributed.sharding.cache_specs`
(``model.init_cache(..., mesh=)``): the slots over the data-parallel axes
where they divide, an attention cache's sequence over ``model``, a
recurrent state's largest trailing dimension over ``model``. Admission
zeroes a slot's state rows on the rank that holds them. The step returns
the whole logits on every rank (gathered inside the step, and so inside
its graph).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import check_capturable, get_concrete_mesh, split_group
from repro_torch.graphs import CudaGraph, require_captured


@dataclasses.dataclass
class Request:
    prompt: list          # token ids
    max_new_tokens: int = 16
    eos_id: int | None = None
    # filled by the engine:
    rid: int = -1
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


def _placed_mesh(model, params):
    """The mesh of placed parameters, or ``None``."""
    leaf = model.embed_weight(params)
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def _zero_slot(t, slot: int) -> None:
    """Zero row ``slot`` of dimension 1 of ``t`` (``(n_periods, B, ...)``)
    in place. Placed, only the rank whose local rows hold the slot writes,
    to its own row: no collective and no read back to the host."""
    if not isinstance(t, DTensor):
        t[:, slot].zero_()
        return
    local = t.to_local()
    _, r = split_group(t, 1)
    b = local.shape[1]
    if slot // b == r:
        local[:, slot % b].zero_()


def _whole_logits(decode_step):
    """``decode_step`` returning its logits whole (a placed step's are
    gathered from their shards; a plain step's come back as they are)."""
    def step(params, cache, batch):
        logits, cache = decode_step(params, cache, batch)
        return (logits.full_tensor() if isinstance(logits, DTensor) else logits), cache

    return step


class ServeEngine:
    """``sampler(logits_row, rid) -> token`` takes a numpy fp32 row of
    logits; the default is greedy argmax, taken on the device for the whole
    batch with one copy of ``B`` ids to the host a step (a custom sampler
    costs one copy of the ``(B, V)`` logits a step). ``device=None`` means
    the CUDA card; ``params`` must live on the engine's device, and on the
    card they and :attr:`cache` are the ones the decode graph captured."""

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 sampler: Callable | None = None, device=None):
        self.device = resolve_device(device)
        where = model._device(params)
        if where != self.device:
            raise ValueError(f"params live on {where}, the engine on {self.device}")
        self.model = model
        self.params = params
        self.B = slots
        self.max_len = max_len
        self.sampler = sampler
        self._rid = itertools.count()
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)       # next position per slot
        self.mesh = _placed_mesh(model, params)
        self.cache = (model.init_cache(slots, max_len, device=self.device)
                      if self.mesh is None else
                      model.init_cache(slots, max_len, device=self.device, mesh=self.mesh))
        if self.device.type == "cuda":
            self._decode = self._graphed_decode()
        else:
            self._decode = (model.decode_step if self.mesh is None
                            else _whole_logits(model.decode_step))
        self._next_tok = np.zeros((slots, 1), np.int32)
        self._pending_prompt: dict[int, list] = {}
        self.steps = 0

    def _graphed_decode(self) -> Callable:
        """``decode(params, cache, batch) -> (logits, cache)`` as
        ``model.decode_step`` is called, replaying one CUDA graph of it over
        this engine's params and cache. The graph's warm-up step writes
        token 0's K/V at position 0 of every slot, a row each request's
        first token overwrites (and ``kv_len`` masks until then). Under a
        mesh the MoE's expert-parallel collectives go into the graph
        (:func:`~repro_torch.distributed.sharding.check_capturable`)."""
        check_capturable(self.mesh or get_concrete_mesh(), self.device)
        params, cache = self.params, self.cache
        step = (self.model.decode_step if self.mesh is None
                else _whole_logits(self.model.decode_step))
        tokens = torch.zeros((self.B, 1), dtype=torch.int32, device=self.device)
        graph = CudaGraph(
            lambda tok, pos: step(params, cache, {"tokens": tok, "pos": pos})[0],
            tokens, tokens[:, 0])

        def decode(p, c, batch):
            require_captured(p, params, "params")
            require_captured(c, cache, "cache")
            return graph(batch["tokens"], batch["pos"]), c

        decode.graph = graph
        return decode

    # ------------------------------------------------------------- intake

    def submit(self, req: Request) -> int:
        req.rid = next(self._rid)
        self.queue.append(req)
        return req.rid

    def _admit(self):
        """Fill free slots; the prompt is fed token-by-token through the
        decode step."""
        for slot in range(self.B):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            if len(req.prompt) + req.max_new_tokens > self.max_len:
                raise ValueError("request exceeds engine max_len")
            self.active[slot] = req
            self.pos[slot] = 0
            self._pending_prompt[slot] = list(req.prompt)
            self._reset_state(slot)

    def _reset_state(self, slot: int) -> None:
        """Zero ``slot``'s rows of every recurrent state of the cache (dict
        entries, stacked over periods: ``(n_periods, B, ...)``) in place, so
        a decode graph captured over the cache still reads them; on a placed
        cache, on the rank that holds the slot (:func:`_zero_slot`). KV
        caches are left as they are: ``kv_len`` masks their stale rows."""
        for entry in self.cache if isinstance(self.cache, list) else ():
            if isinstance(entry, dict):
                for t in entry.values():
                    _zero_slot(t, slot)

    # -------------------------------------------------------------- step

    def _sampler(self, logits) -> Callable:
        """``pick(slot, req)``: the token of an active slot from the step's
        ``(B, 1, V)`` fp32 logits, copied to the host once a step."""
        if self.sampler is None:
            greedy = logits[:, 0].argmax(dim=-1).cpu().tolist()
            return lambda slot, req: greedy[slot]
        rows = logits[:, 0].cpu().numpy()
        return lambda slot, req: self.sampler(rows[slot], req.rid)

    def step(self):
        """One batched decode step across all active slots."""
        self._admit()
        if not any(a is not None for a in self.active):
            return False
        # the decode kernel reads kv_len = pos + 1 without a sync: the
        # positions are checked here, where they already are
        if self.pos.min() < 0 or self.pos.max() >= self.max_len:
            raise RuntimeError(f"slot positions {self.pos} outside [0, {self.max_len})")
        pending = self._pending_prompt
        tokens = np.zeros((self.B, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            if pending.get(slot):
                tokens[slot, 0] = pending[slot].pop(0)
            else:
                tokens[slot, 0] = self._next_tok[slot, 0]
        # host arrays: the eager step moves them, the graph copies them in
        logits, self.cache = self._decode(
            self.params, self.cache,
            {"tokens": torch.from_numpy(tokens), "pos": torch.from_numpy(self.pos)},
        )
        pick = self._sampler(logits)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            still_prompt = bool(pending.get(slot))
            if still_prompt:
                continue
            tok = int(pick(slot, req))
            self._next_tok[slot, 0] = tok
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.output) >= req.max_new_tokens:
                req.done = True
                self.active[slot] = None   # recycle the slot
        self.steps += 1
        return True

    # -------------------------------------------------------------- run

    def run(self, requests, *, max_steps: int | None = None):
        """Serve a list of requests to completion; returns them (done)."""
        for r in requests:
            self.submit(r)
        budget = max_steps if max_steps is not None else 10_000
        while budget and (self.queue or any(
            a is not None for a in self.active
        )):
            if not self.step():
                break
            budget -= 1
        return requests
