"""The recurrent mixers (Mamba, mLSTM, sLSTM) over placed parameters, run
on each rank's local shards.

The reference places these mixers with two hints each (Mamba's ``xin``
and ``y`` over ``model`` on the inner dimension, ``repro/models/ssm.py``
lines 86 and 113; mLSTM's heads and ``y``'s columns, ``xlstm.py`` lines 53
and 79) and lets GSPMD split the rest. The port takes ``to_local`` at the
mixer's boundary instead, as the MoE does
(:func:`repro_torch.models.layers._moe_placed`): the mixer's math runs on
local tensors, so its Python loops (the sLSTM's time steps, the chunked
scans) dispatch no DTensor op, and its collectives are the explicit ones
of :mod:`repro_torch.distributed.collectives`, Megatron's:

* the input enters the ``model`` group (``enter``: its gradient summed);
* a column-parallel product whose weight holds several column blocks
  (Mamba's ``w_in``, mLSTM's ``w_qkv`` and ``w_if``) is regrouped, so each
  rank holds its channels of every block (``regroup``); where the heads
  do not divide ``model`` the product is gathered whole instead
  (``gather_shards``) and every rank runs every head, as
  :func:`repro_torch.models.layers._heads` gathers;
* Mamba's ``w_bcdt`` is row-parallel and feeds split work: its partial
  sums are all-reduced both ways;
* the output projection is row-parallel: the partial sums are all-reduced
  (``reduce``), the block's one all-reduce.

The mixer itself is written once: it calls the three hooks of
:class:`Split` (``columns``, ``rows``, ``out``), which do nothing
unplaced (:data:`WHOLE`).

The state caches keep the reference's specs
(:func:`~repro_torch.distributed.sharding.cache_specs`), which put a
state's largest trailing dimension over ``model`` (xLSTM's head dimension,
where the weights split heads). The mixer moves a state into its working
layout (the batch as the input's, the split channels or heads over
``model``) at its boundary and writes it back in place in the cache's
layout; on one rank both are the cache's own storage and nothing moves.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import enter, gather_shards, reduce, regroup


class Split:
    """A mixer's inner dimension over ``model`` on this rank. ``group``
    ``None`` is the whole mixer on every rank. ``heads``: each rank runs its
    own channels (Mamba) or heads (xLSTM, where they divide the group);
    otherwise every rank runs them all and keeps its slice of the output.
    ``split`` names the weights whose columns are split over the group."""

    def __init__(self, group=None, rank: int = 0, size: int = 1, heads: bool = True,
                 split=frozenset()):
        self.group, self.rank, self.size, self.heads = group, rank, size, heads
        self.split = frozenset(split)

    def columns(self, y, name: str, n: int):
        """The working channels of ``y = x @ w[name]``, a product whose
        weight holds ``n`` column blocks. A weight left whole (its columns
        do not divide the group) is whole only where the heads are: where
        they divide, so do the columns."""
        if self.group is None or name not in self.split:
            return y
        return (regroup(y, self.group, n) if self.heads
                else gather_shards(y, self.group, y.ndim - 1))

    def rows(self, y):
        """A row-parallel product that feeds split work: the sum over the
        group both ways."""
        if self.group is None:
            return y
        return enter(reduce(y, self.group), self.group)

    def out(self, y, w):
        """The row-parallel output projection of the working channels
        ``y``, summed over the group."""
        if self.group is None:
            return y @ w
        if not self.heads:
            c = y.shape[-1] // self.size
            y = y[..., self.rank * c:(self.rank + 1) * c]
        return reduce(y @ w, self.group)


WHOLE = Split()


def _local_weight(w, keep_model: bool):
    """A placed mixer weight as this rank uses it, plain: gathered over
    every mesh dimension but ``model`` (kept where ``keep_model``), as
    :func:`~repro_torch.distributed.sharding.gather_param` does."""
    names = w.device_mesh.mesh_dim_names
    want = [pl if (keep_model and name == sharding.MODEL) or pl.is_replicate()
            else Replicate() for name, pl in zip(names, w.placements)]
    return sharding.relayout(w, want)[0]


def _state_placements(mesh, batch: set, model: int | None, dim: int) -> tuple:
    return tuple(Shard(0) if i in batch else Shard(dim) if i == model else Replicate()
                 for i in range(mesh.ndim))


def _cache_placements(cfg, t, mesh) -> tuple:
    """The cache's placements of one period's state ``t`` (global shape):
    :func:`~repro_torch.distributed.sharding.cache_specs` of it stacked."""
    shape = type("CacheShape", (), {"global_batch": t.shape[0]})
    meta = torch.empty((1,) + tuple(t.shape), device="meta")
    spec = sharding.cache_specs(cfg, {"t": meta}, shape)["t"]
    return sharding.placements(sharding.P(*spec[1:]), mesh)


def run_placed(core, key: str, p, cfg, x, *, cache, want_cache, out: str,
               state_dims: dict, n_heads: int | None = None):
    """``core(p, cfg, x, cache, want_cache, tp)`` (a mixer's math, ``p``
    ``{key: weights}``) over the placed ``p`` and ``x`` (B, S, d): on this
    rank's rows of ``x`` and its shards, with the collectives of
    :class:`Split`. The mixer is split over ``model`` where its row-parallel
    output weight ``out`` is (Megatron's mode, ``model`` no batch axis);
    ``n_heads`` (xLSTM) says whether its heads divide the split (Mamba
    splits channels). ``state_dims`` gives each state's split dimension
    (batch first). Returns ``(out placed as x, cache)``: the decode cache
    written in place, the prefill's states placed by the cache's specs."""
    mesh = sharding.placed_mesh() or x.device_mesh   # this world's (see mesh_group)
    names = mesh.mesh_dim_names
    model = names.index(sharding.MODEL) if sharding.MODEL in names else None
    batch = {i for i, pl in enumerate(x.placements) if pl == Shard(0) and mesh.size(i) > 1}
    weights = p[key]
    split = (model is not None and model not in batch and mesh.size(model) > 1
             and sharding.get_parallelism() == "tp"
             and weights[out].placements[model] == Shard(0))
    group, rank, size, heads = None, 0, 1, True
    if split:
        group, rank = sharding.mesh_group(mesh, (sharding.MODEL,))
        size = mesh.size(model)
        heads = n_heads is None or n_heads % size == 0
    placed = {k: _local_weight(w, keep_model=split) for k, w in weights.items()}
    col_split = {k for k, w in placed.items()
                 if split and w.placements[model] == Shard(w.ndim - 1)}
    local = {}
    for k, w in placed.items():
        over = set(batch)
        if split and w.placements[model].is_replicate():
            over.add(model)   # used by every model rank, each with its own part
        wl = w.to_local()
        if over:
            wl = enter(wl, sharding.mesh_group(mesh, tuple(names[i] for i in sorted(over)))[0])
        local[k] = wl
    tp = Split(group, rank, size, heads, col_split)
    xl = x.to_local()
    if split:
        xl = enter(xl, group)
    state_model = model if split and heads else None
    lay = {k: _state_placements(mesh, batch, state_model, d) for k, d in state_dims.items()}
    wrap = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False)  # noqa: E731
    if cache is None:
        y, new = core({key: local}, cfg, xl, None, want_cache, tp)
        if new is not None:   # the prefill's states, placed by the cache's specs
            new = {k: wrap(t, lay[k]) for k, t in new.items()}
            new = {k: sharding.relayout(t, _cache_placements(cfg, t, mesh))[0]
                   for k, t in new.items()}
        return wrap(y, x.placements), new
    work, moved = {}, {}
    for k, t in cache.items():
        wt, moved[k] = sharding.relayout(t, lay[k])
        work[k] = wt.to_local()
    y, _ = core({key: local}, cfg, xl, work, want_cache, tp)
    for k, t in cache.items():
        if moved[k]:   # back in the cache's layout, into its storage
            back = sharding.relayout(wrap(work[k], lay[k]), t.placements)[0]
            t.to_local().copy_(back.to_local())
    return wrap(y, x.placements), cache
