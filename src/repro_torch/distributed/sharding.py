"""Sharding rules: logical parameter and activation axes -> mesh placements.
Mirrors ``repro/distributed/sharding.py``.

Megatron-style tensor parallelism over the ``model`` axis, (optionally
FSDP-) data parallelism over ``data``, and pure data parallelism over
``pod`` for the multi-pod mesh. Expert parallelism (MoE) also maps onto
``model``. The reference's conventions (weights stored ``x @ W``):

  embedding     (vocab, d_model)        -> (model, fsdp?)     vocab-parallel
  attn in-proj  (d_model, heads*hd)     -> (fsdp?, model)     column-parallel
  attn out-proj (heads*hd, d_model)     -> (model, fsdp?)     row-parallel
  mlp up/gate   (d_model, d_ff)         -> (fsdp?, model)
  mlp down      (d_ff, d_model)         -> (model, fsdp?)
  moe experts   (E, d_model, d_ff)      -> (model=EP, fsdp?, None)
  norms/bias    replicated (fsdp over longest dim when fsdp=True)

A ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions takes
the place of a ``jax.sharding.Mesh``, and its dimensions' process groups the
place of the mesh axes. :func:`abstract_mesh` names axes and sizes with no
devices, for the rules alone. :func:`use_mesh` makes a mesh of either kind
ambient (a ``contextvars.ContextVar``).

The reference is single-controller: every array is global, and GSPMD, which
never changes a value, places what its ``shard_map`` regions do not split.
The port runs the program on every rank with the global inputs and the
whole parameters, and splits the work of those regions only:
:func:`shard_plan_apply` (the generator over the data-parallel ranks) and
the MoE's expert-parallel path (``repro_torch.models.layers``). Each
region is bracketed by the autograd Functions of
:mod:`repro_torch.distributed.collectives`. :func:`param_specs` and
:func:`named_shardings` record the reference's placements; the parameters
themselves stay whole on every rank (the dense layers are not split over
``model``, nor the parameters over ``data`` under ``fsdp``).

All helpers degrade to no-ops with no mesh, so the same model code runs on
one device and under a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.collectives import enter, gather
from repro_torch.tree import tree_map

# logical axis names used by the model code
BATCH = ("pod", "data")   # global batch is split across pod x data
MODEL = "model"
DATA = "data"

# Parallelism mode (set by the launcher per arch config):
#   "tp"   -- Megatron TP over `model` + (optionally FSDP-)DP over `data`.
#   "fsdp" -- ZeRO-3 over all non-pod axes: `model` becomes a second
#             data-parallel axis; no tensor parallelism.
_MODE = {"mode": "tp"}
_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


def set_parallelism(mode: str):
    if mode not in ("tp", "fsdp"):
        raise ValueError(f"parallelism is 'tp' or 'fsdp', got {mode!r}")
    _MODE["mode"] = mode


def get_parallelism() -> str:
    return _MODE["mode"]


def batch_axes() -> tuple:
    return ("pod", "data", "model") if _MODE["mode"] == "fsdp" else BATCH


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``, an
    axis name or a tuple of axis names (the dimension split over their
    product, the first outermost). Compares as the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


class AbstractMesh:
    """Axis names and sizes with no devices: what the rules read."""

    def __init__(self, axis_sizes: tuple, axis_names: tuple):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} names")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, axis_sizes)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axis_sizes: tuple, axis_names: tuple) -> AbstractMesh:
    """A mesh of ``axis_names`` with ``axis_sizes`` and no devices (the
    rules' tests and a dry run of the rules)."""
    return AbstractMesh(axis_sizes, axis_names)


def _names(mesh) -> tuple:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(getattr(mesh, "axis_names", ()))


def get_abstract_mesh():
    """The ambient mesh of either kind (:func:`use_mesh`), or ``None``; a
    mesh with no axis names counts as none. Tests monkeypatch this
    function."""
    mesh = _MESH.get()
    return mesh if mesh is not None and _names(mesh) else None


def get_concrete_mesh():
    """The ambient ``DeviceMesh``, or ``None``: an abstract mesh names axes
    for the rules but has no ranks to split work over."""
    mesh = _MESH.get()
    return mesh if isinstance(mesh, DeviceMesh) and _names(mesh) else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a named ``DeviceMesh`` or an :class:`AbstractMesh`)
    ambient for the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} for a mesh of either kind."""
    if mesh is None:
        return {}
    if isinstance(mesh, DeviceMesh):
        return dict(zip(_names(mesh), mesh.shape))
    return dict(mesh.shape)


def mesh_group(mesh: DeviceMesh, dims: tuple):
    """The process group over the mesh dimensions ``dims`` (flattened, the
    first outermost, as the reference's tuple entries split), and this
    rank's place in it."""
    dims = tuple(dims)
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    else:
        group = mesh[dims]._flatten().get_group()
    return group, dist.get_rank(group)


def region_groups(mesh: DeviceMesh) -> list:
    """The process groups the sharded regions use over ``mesh``: the
    data-parallel ranks', ``model``'s, and both together."""
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    tp = ("model",) if "model" in sizes else ()
    return [mesh_group(mesh, dims)[0] for dims in (dp, tp, dp + tp) if dims]


def check_capturable(mesh, device) -> None:
    """Ready ``mesh``'s collectives for capture in a CUDA graph on
    ``device``: raise ``ValueError`` unless every group the regions use is
    NCCL (no other backend's collectives can be captured), then run one
    all-reduce over each on the card, so that every communicator exists
    before a capture. With no mesh, nothing."""
    if mesh is None:
        return
    groups = region_groups(mesh)
    other = sorted({dist.get_backend(g) for g in groups} - {"nccl"})
    if other:
        raise ValueError(
            f"a CUDA graph captures NCCL collectives only; this mesh's groups are "
            f"{other}: run on a mesh over an NCCL process group, or without a mesh")
    for g in groups:
        dist.all_reduce(torch.ones(1, device=device), group=g)
    torch.cuda.synchronize(device)


def is_writer() -> bool:
    """Whether this process writes the files every rank would write alike
    (checkpoints): global rank 0, or a process in no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _filter(spec: P, shape=None) -> P | None:
    """Drop spec entries whose axes aren't in the active mesh, or whose mesh
    extent doesn't divide the tensor dim; None if nothing remains."""
    mesh = get_abstract_mesh()
    axes = _names(mesh) if mesh is not None else ()
    sizes = mesh_axis_sizes(mesh)

    def axis_size(entry):
        if isinstance(entry, tuple):
            return math.prod(sizes.get(a, 1) for a in entry)
        return sizes.get(entry, 1)

    fsdp_mode = _MODE["mode"] == "fsdp"
    out = []
    for i, entry in enumerate(spec):
        dim = None if shape is None or i >= len(shape) else shape[i]
        if entry is None:
            out.append(None)
            continue
        if fsdp_mode:
            # `model` is a batch axis: widen BATCH entries, drop bare
            # tensor-parallel constraints
            if entry == BATCH:
                entry = ("pod", "data", "model")
            elif entry == MODEL:
                out.append(None)
                continue
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            entry = kept if kept else None
        elif entry not in axes:
            entry = None
        if entry is not None and dim is not None and dim % axis_size(entry):
            entry = None
        out.append(entry)
    if all(e is None for e in out):
        return None
    return P(*out)


def placements(spec, mesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh``'s dimensions: a mesh
    dimension named in entry ``i`` is ``Shard(i)``, any other
    ``Replicate()``. A dimension split over ``("data", "model")`` is
    ``Shard(i)`` on both, in mesh order: the row-major split the
    reference's entry means."""
    out = []
    for name in _names(mesh):
        dims = [i for i, e in enumerate(spec or ())
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, *entries):
    """The reference's sharding constraint: ``x`` itself, since a hint
    never changes a value. A ``DTensor`` is redistributed to the filtered
    placements over its own mesh."""
    if not isinstance(x, DTensor):
        return x
    with use_mesh(x.device_mesh):
        spec = _filter(P(*entries), tuple(x.shape))
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def shard_batch(x):
    """Shard the leading (batch) axis over (pod, data)."""
    return constrain(x, BATCH, *([None] * (x.ndim - 1)))


def shard_plan_apply(apply_fn, params, z, plan, *, mesh=None):
    """Run a compiled :class:`repro_torch.kernels.plan.TconvPlan` generator
    batch-split over the data-parallel ranks of ``mesh`` (else the ambient
    ``DeviceMesh``).

    ``apply_fn(params, z, plan) -> out``, the leading axis of ``z`` and
    ``out`` the batch. Under ``(pod, data)`` ranks whose count divides the
    batch, rank ``r`` of their group runs ``apply_fn`` on its contiguous
    slice of ``z`` with the parameters through ``enter`` and returns the
    ranks' outputs through ``gather``: every rank gets the whole batch and
    each parameter's gradient summed over the ranks. A one-rank mesh goes
    through the collectives too, as the reference's 1x1 mesh goes through
    ``shard_map``. With no ``DeviceMesh``, no ``pod``/``data`` dimension or
    a batch the ranks do not divide, it runs ``apply_fn`` unsharded.
    """
    mesh = mesh if mesh is not None else get_concrete_mesh()
    if mesh is None:
        return apply_fn(params, z, plan)
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_shards = math.prod(sizes[a] for a in dp)
    if not dp or z.shape[0] % n_shards:
        return apply_fn(params, z, plan)
    group, rank = mesh_group(mesh, dp)
    b = z.shape[0] // n_shards
    live = tree_map(lambda t: enter(t, group), params)
    return gather(apply_fn(live, z[rank * b:(rank + 1) * b], plan), group)


# ---------------------------------------------------------------------------
# Parameter sharding rules, keyed by parameter path (joined with '/').
# Order matters: first regex match wins.
# ---------------------------------------------------------------------------

def param_rules(fsdp: bool):
    f = DATA if fsdp else None
    return [
        # MoE expert banks: (E, d_in, d_out) -> experts over model (EP)
        (r"experts?/(w_gate|w_up)$", P(MODEL, f, None)),
        (r"experts?/w_down$", P(MODEL, None, f)),
        (r"router/w$", P(f, None)),
        # embeddings / lm head: vocab-parallel
        (r"(embed|lm_head)/w$", P(MODEL, f)),
        (r"pos_embed/w$", P(None, f)),
        # attention projections
        (r"(wq|wk|wv|in_proj|qkv)/w$", P(f, MODEL)),
        (r"(wq|wk|wv|in_proj|qkv)/b$", P(MODEL)),
        (r"(wo|out_proj)/w$", P(MODEL, f)),
        (r"(wo|out_proj)/b$", P(None)),
        # dense mlp
        (r"(w_gate|w_up)/w$", P(f, MODEL)),
        (r"w_down/w$", P(MODEL, f)),
        # mamba / xlstm mixers: inner dim over model
        (r"mamba/(w_in|dt_w)$", P(f, MODEL)),
        (r"mamba/(w_out)$", P(MODEL, f)),
        (r"mamba/(conv_w)$", P(None, MODEL)),
        (r"mamba/(a_log)$", P(MODEL, None)),
        (r"mamba/(conv_b|d|dt_bias)$", P(MODEL)),
        (r"mamba/(w_bcdt)$", P(MODEL, None)),
        (r"(mlstm|slstm)/(w_qkv|w_if|w_in)$", P(f, MODEL)),
        (r"(mlstm|slstm)/(w_out|w_down)$", P(MODEL, f)),
        (r"slstm/w_rec$", P(MODEL, None, None)),
        # conv frontends (whisper stub projection, gan)
        (r"conv\d*/w$", P(None, None, f, MODEL)),
        # norms, scalars, biases: replicate (or fsdp the single dim)
        (r".*", None),
    ]


def spec_for_path(path: str, fsdp: bool) -> P:
    for pattern, spec in param_rules(fsdp):
        if re.search(pattern, path):
            return spec if spec is not None else P()
    return P()


def _leaf_paths(tree, prefix=()):
    """``(path, leaf)`` for every leaf of a tree of dicts and lists: the
    keys and list indices joined with ``/``, as the reference names them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _leaf_paths(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, tree[k], prefix + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_paths(fn, sub, prefix + (str(i),)) for i, sub in enumerate(tree)]
    return fn("/".join(prefix), tree)


def param_specs(params, fsdp: bool = False):
    """A tree of :class:`P` matching ``params`` (tensors of any device,
    the meta device included).

    Leading stacked-layer axes are detected by rank mismatch: rules
    describe the per-layer rank, and any extra leading dims get ``None``
    entries prepended. Axis entries whose mesh extent doesn't divide the dim
    are dropped.
    """
    def one(path, leaf):
        if _MODE["mode"] == "fsdp":
            # ZeRO-3: shard ONE dim of every matrix over (data x model),
            # trying dims largest-first so a non-divisible preferred dim
            # falls back instead of replicating
            if leaf.ndim >= 1:
                order = sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i])
                for i in order:
                    base = [None] * leaf.ndim
                    base[i] = ("data", "model")
                    spec = _filter(P(*base), tuple(leaf.shape))
                    if spec is not None:
                        return spec
            return P()
        spec = spec_for_path(path, fsdp)
        extra = leaf.ndim - len(spec)
        if extra > 0:
            spec = P(*([None] * extra), *spec)
        elif extra < 0:
            spec = P(*spec[-leaf.ndim:]) if leaf.ndim else P()
        return _filter(spec, tuple(leaf.shape)) or P()

    return _map_paths(one, params)


def named_shardings(params, mesh, fsdp: bool = False):
    """The DTensor placements over ``mesh`` of every parameter, a tree
    matching ``params``: :func:`param_specs` filtered by ``mesh``."""
    with use_mesh(mesh):
        specs = param_specs(params, fsdp)
    return _map_paths(lambda _, spec: placements(spec, mesh), specs)
