"""The collectives that bracket a sharded region, as autograd Functions.

The reference is single-controller: every array is global, and only its
``shard_map`` regions split the work. The port runs that program on every
rank at once. Each rank holds the global inputs and the whole parameters,
and only the regions the reference splits split the work
(:func:`repro_torch.distributed.sharding.shard_plan_apply`, the MoE's
expert-parallel path). Every rank then computes the same loss downstream of
a region, so each region is bracketed by conjugate Functions over a process
group, as Megatron's are:

==========  ================================  ================================
Function    forward                           backward
==========  ================================  ================================
``enter``   identity                          all-reduce (sum)
``gather``  all-gather of the ranks' slices   this rank's slice of the gradient
``reduce``  all-reduce (sum)                  identity
==========  ================================  ================================

A parameter used inside a region gets the sum of the ranks' partial
gradients (``enter``'s all-reduce); one used outside gets the same gradient
on every rank, so no trainer needs a gradient all-reduce of its own.
``gather``'s backward takes a slice and not a reduce-scatter: the gradient
that reaches it is the same on every rank, and a sum would count it once a
rank.

``gather_shards`` is the one all-gather inside a region (the FSDP gather of
an expert slice over ``data``). What follows it differs by rank, so its
backward is the transpose of the reference's ``all_gather``: the sum over
the ranks, of which this rank keeps its slice.

``regroup`` moves the columns of a column-parallel product whose weight
holds ``n`` concatenated blocks (Mamba's ``x | z``, mLSTM's ``q | k | v``):
a contiguous split gives each rank whole blocks or parts of them, and one
``all_to_all_single`` hands each rank its own channels of every block, in
block order. Its backward is the inverse exchange.

gloo takes CUDA tensors in all-reduce and broadcast but not in all-gather;
there the all-gather is one broadcast a rank into the full buffer, an exact
copy. (An all-reduce over a zero-filled buffer would turn ``-0.0`` into
``+0.0``.) With one rank every Function is a copy: the bits do not change.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    b = front.shape[0]
    out = front.new_empty((n * b,) + tuple(front.shape[1:]))
    if front.is_cuda and dist.get_backend(group) == "gloo":
        me = dist.get_rank(group)
        for r in range(n):
            part = out[r * b:(r + 1) * b]
            if r == me:
                part.copy_(front)
            dist.broadcast(part, src=dist.get_global_rank(group, r), group=group)
    else:
        dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, in a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, in group-rank order."""
    b = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * b, b)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(all_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


def _regroup_plan(n: int, m: int, r: int) -> tuple:
    """The exchange of :func:`regroup` on rank ``r`` of ``m``: sub-chunk
    ``a`` of the ``n`` this rank holds is global sub-chunk ``q = r n + a``
    of the ``n m`` (each ``1/m`` of a block), bound for rank ``q mod m``
    as a piece of block ``q // m``. Returns ``(send order, sub-chunks
    sent to each rank, sub-chunks received from each rank)``; what a rank
    receives, in source order, is its pieces in block order."""
    dest = [(r * n + a) % m for a in range(n)]
    order = sorted(range(n), key=lambda a: dest[a])
    sent = [dest.count(t) for t in range(m)]
    got = [sum((j * m + r) // n == s for j in range(n)) for s in range(m)]
    return order, sent, got


def _exchange(chunks: torch.Tensor, group, out_splits: list, in_splits: list):
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, out_splits, in_splits, group=group)
    return out


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n):
        m, r = dist.get_world_size(group), dist.get_rank(group)
        order, sent, got = _regroup_plan(n, m, r)
        ctx.group, ctx.plan, ctx.shape = group, (order, sent, got), y.shape
        lead, w = y.shape[:-1], y.shape[-1]
        chunks = y.reshape(-1, n, w // n).transpose(0, 1)[order]     # (n, R, s)
        out = _exchange(chunks, group, got, sent)                    # block order
        return out.transpose(0, 1).reshape(*lead, w)

    @staticmethod
    def backward(ctx, g):
        order, sent, got = ctx.plan
        n, w = len(order), g.shape[-1]
        back = _exchange(g.reshape(-1, n, w // n).transpose(0, 1), ctx.group, sent, got)
        inv = [order.index(a) for a in range(n)]
        return back[inv].transpose(0, 1).reshape(ctx.shape), None, None


def regroup(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's channels of each of the ``n`` column blocks of a
    product ``y`` (..., W) whose weight's columns (``n`` blocks of ``c``)
    are split contiguously over ``group``: ``(..., W)``, the ``n`` pieces
    of ``c / size`` columns in block order. ``c`` must divide by the
    group's size. With ``n == 1`` (or one rank) nothing moves."""
    if n == 1 or dist.get_world_size(group) == 1:
        return y
    return _Regroup.apply(y, group, n)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Into a region: ``x`` itself; the gradient summed over ``group``."""
    return _Enter.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Out of a region: the ranks' slices joined along ``dim``; the
    gradient's slice of this rank."""
    return _Gather.apply(x, group, dim)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Out of a region: the sum over ``group`` (the reference's ``psum``);
    the gradient as it is."""
    return _Reduce.apply(x, group)


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Inside a region: the ranks' shards joined along ``dim``; the
    gradient summed over ``group``, this rank's shard of it."""
    return _GatherShards.apply(x, group, dim)
