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

The reference is single-controller: every array is global, and GSPMD places
it by ``in_shardings`` and the model's ``constrain`` hints. The port places
its state the same way once asked to: :func:`distribute_params` turns every
parameter into a ``DTensor`` with the placements :func:`named_shardings`
computes (Megatron's column- and row-parallel splits over ``model``, and
ZeRO-3 over ``data`` under ``fsdp``), :func:`opt_specs_from` and
:func:`cache_specs` give the optimizer moments' and the KV caches' specs
(the attention cache's sequence over ``model``), and :func:`place_tree`
places a tree by a tree of specs. Under :func:`use_mesh` with
``placed=True`` :func:`constrain` and :func:`shard_batch` enter a plain
tensor into the mesh (replicated except where an entry names an axis), and
redistribute a ``DTensor``, as the reference's hints do; DTensor's sharding
propagation, the counterpart of GSPMD, places the rest.

Unplaced, the port runs the program on every rank with the global inputs
and the whole parameters, and splits the work of two regions only:
:func:`shard_plan_apply` (the generator over the data-parallel ranks) and
the MoE's expert-parallel path (``repro_torch.models.layers``), each
bracketed by the autograd Functions of
:mod:`repro_torch.distributed.collectives`.

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
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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
_PLACED = contextvars.ContextVar("repro_torch_placed", default=False)


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
def use_mesh(mesh, *, placed: bool = False):
    """Make ``mesh`` (a named ``DeviceMesh`` or an :class:`AbstractMesh`)
    ambient for the block. ``placed=True`` (a ``DeviceMesh`` whose state is
    placed, :func:`distribute_params`) makes :func:`constrain` and
    :func:`shard_batch` enter plain tensors into it."""
    token = _MESH.set(mesh)
    ptoken = _PLACED.set(bool(placed) and isinstance(mesh, DeviceMesh))
    try:
        yield mesh
    finally:
        _PLACED.reset(ptoken)
        _MESH.reset(token)


def placed_mesh():
    """The ambient ``DeviceMesh`` when it is placed (:func:`use_mesh` with
    ``placed=True``), else ``None``."""
    return get_concrete_mesh() if _PLACED.get() else None


@contextlib.contextmanager
def placement_of(tensor):
    """The block under ``tensor``'s mesh, placed, when ``tensor`` is a
    ``DTensor``; otherwise the ambient state unchanged. The model enters
    it from its parameters, so a placed tree runs placed wherever it is
    called from."""
    if not isinstance(tensor, DTensor):
        yield None
        return
    with use_mesh(tensor.device_mesh, placed=True) as mesh:
        yield mesh


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} for a mesh of either kind."""
    if mesh is None:
        return {}
    if isinstance(mesh, DeviceMesh):
        return dict(zip(_names(mesh), mesh.shape))
    return dict(mesh.shape)


_GROUPS: dict = {}   # (mesh, dims) -> (world, group, rank)


def mesh_group(mesh: DeviceMesh, dims: tuple):
    """The process group over the mesh dimensions ``dims`` (flattened, the
    first outermost, as the reference's tuple entries split), and this
    rank's place in it. Cached by the mesh's layout for the current world:
    meshes of one layout compare equal, and DTensor hands back an op's
    cached output spec, whose mesh may be an earlier world's object of the
    same layout. Slicing a mesh runs tensor ops, which a trace on meta or
    fake tensors must not see: :func:`region_groups` makes the groups
    first."""
    dims = tuple(dims)
    world = dist.group.WORLD
    hit = _GROUPS.get((mesh, dims))
    if hit is None or hit[0] is not world:
        if len(dims) == 1:
            group = mesh.get_group(dims[0])
        else:
            group = mesh[dims]._flatten().get_group()
        hit = _GROUPS[(mesh, dims)] = (world, group, dist.get_rank(group))
    return hit[1], hit[2]


def region_groups(mesh: DeviceMesh) -> list:
    """The process groups the sharded regions and placed programs use over
    ``mesh``: each dimension's own (DTensor's collectives), the
    data-parallel ranks', ``model``'s, and both together."""
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    tp = ("model",) if "model" in sizes else ()
    dims = [(a,) for a in _names(mesh)] + [d for d in (dp, tp, dp + tp) if d]
    out = []
    for d in dict.fromkeys(dims):
        g = mesh_group(mesh, d)[0]
        if all(g is not h for h in out):
            out.append(g)
    return out


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


def parallelism_for(cfg, kind: str, global_batch: int, mesh) -> str:
    """The mode a step of ``kind`` (``train``, ``prefill`` or ``decode``)
    runs in: the config's ``train_parallelism`` when training, its
    ``parallelism`` when serving; ``fsdp`` falls back to ``tp`` when the
    batch does not divide the mesh's ranks (ZeRO-3 over the whole mesh
    needs a sequence a rank), as the reference's dry run chooses."""
    mode = cfg.train_parallelism if kind == "train" else cfg.parallelism
    if mode == "fsdp" and global_batch % math.prod(mesh_axis_sizes(mesh).values()):
        mode = "tp"
    return mode


def is_placed(tree) -> bool:
    """Whether ``tree``'s leaves are placed (``DTensor``s)."""
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], DTensor)


def full_tree(tree):
    """Every placed leaf of ``tree`` gathered whole (``full_tensor``, a
    collective every rank calls); plain leaves as they are."""
    return _map_spec_tree(
        lambda t, _: t.full_tensor() if isinstance(t, DTensor) else t, tree, None)


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
    """The reference's sharding constraint. A ``DTensor`` is redistributed
    to the filtered placements over its own mesh; a plain tensor under a
    placed mesh (:func:`placed_mesh`) enters it with those placements, each
    rank keeping its slice of the whole tensor it holds; any other plain
    tensor is ``x`` itself, since a hint never changes a value."""
    if not isinstance(x, DTensor):
        mesh = placed_mesh()
        return x if mesh is None else enter_mesh(x, mesh, *entries)
    with use_mesh(x.device_mesh):
        spec = _filter(P(*entries), tuple(x.shape))
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def enter_mesh(x, mesh, *entries):
    """The plain tensor ``x``, which every rank holds whole, as a
    ``DTensor`` over ``mesh`` placed by ``entries`` (filtered; an empty
    spec replicates): each rank keeps its own slice, with no collective."""
    with use_mesh(mesh):
        spec = _filter(P(*entries), tuple(x.shape)) if entries else None
    return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)


def split_group(t, dim: int):
    """The process group over the mesh dimensions that split dimension
    ``dim`` of the placed ``t`` (the first outermost), and this rank's
    place along them; ``(None, 0)`` where none does."""
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names[i] for i, p in enumerate(t.placements)
                  if isinstance(p, Shard) and p.dim == dim)
    return mesh_group(mesh, names) if names else (None, 0)


def relayout(t, want) -> tuple:
    """``(t placed by want, moved)``: the ``DTensor`` ``t`` redistributed to
    the placements ``want``, ``moved`` whether data crossed ranks. Where
    ``want`` differs only on mesh dimensions of one rank the local tensor
    is the same and is relabelled as it is (a view, no collective), so an
    in-place write to it still lands in ``t``."""
    want = tuple(want)
    if tuple(t.placements) == want:
        return t, False
    mesh = t.device_mesh
    if all(mesh.size(i) == 1 for i, (a, b) in enumerate(zip(t.placements, want)) if a != b):
        return DTensor.from_local(t.to_local(), mesh, want, run_check=False,
                                  shape=t.shape, stride=t.stride()), False
    return t.redistribute(mesh, want), True


def replicate(x, mesh):
    """The plain tensor ``x`` (the same on every rank) as a ``DTensor``
    replicated over ``mesh``: RoPE's tables, masks and the like."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def gather_param(w):
    """A placed parameter as it is used: its ``data``-parallel dimensions
    (``pod`` and ``data``; every dimension under ``fsdp`` mode, where
    ``model`` is one too) gathered to ``Replicate``, its ``model`` split
    kept. The FSDP gather is explicit here so that DTensor re-lays no
    activation instead; its backward reduce-scatters the gradient back to
    the parameter's shard. A plain tensor, or one with nothing to gather,
    is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    every = _MODE["mode"] == "fsdp"
    names = _names(w.device_mesh)
    want = tuple(Replicate() if (every or name != MODEL) and not p.is_replicate() else p
                 for name, p in zip(names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


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


# ---------------------------------------------------------------------------
# Placement of the state: parameters, optimizer moments, caches, batches.
# The specs follow the reference's launch/dryrun.py.
# ---------------------------------------------------------------------------

def _map_spec_tree(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and NamedTuples (the
    KV caches) and its matching tree of specs (``None`` for every leaf
    when ``specs`` is ``None``)."""
    sub = (lambda k: None) if specs is None else (lambda k: specs[k])
    if isinstance(tree, dict):
        return {k: _map_spec_tree(fn, tree[k], sub(k)) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_spec_tree(fn, t, sub(i)) for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_spec_tree(fn, t, sub(i)) for i, t in enumerate(tree))
    return fn(tree, specs)


def state_leaves(tree) -> list:
    """The leaves of a state tree (dicts in sorted-key order, lists, and
    the caches' NamedTuples), in the reference's leaf order."""
    out = []
    _map_spec_tree(lambda leaf, _: out.append(leaf), tree, None)
    return out


def place_tree(tree, mesh, specs):
    """Every leaf of ``tree`` (which every rank holds whole) as a
    ``DTensor`` over ``mesh`` placed by its spec in ``specs``: each rank
    keeps its slice, with no collective. On a mesh of one rank the slice
    is the leaf itself, wrapped without a copy (its storage shared)."""
    def one(leaf, spec):
        if mesh.size() == 1:
            return DTensor.from_local(leaf.detach(), mesh, placements(spec, mesh),
                                      run_check=False).requires_grad_(leaf.requires_grad)
        return distribute_tensor(leaf, mesh, placements(spec, mesh), src_data_rank=None)

    return _map_spec_tree(one, tree, specs)


def distribute_params(tree, mesh, fsdp: bool = False):
    """The parameter tree placed over ``mesh``: every leaf a ``DTensor``
    with the placements :func:`named_shardings` gives (this rank keeps its
    slice of the whole leaf it holds). The parallelism mode
    (:func:`set_parallelism`) chooses the rules, as it does for
    :func:`param_specs`."""
    with use_mesh(mesh):
        specs = param_specs(tree, fsdp)
    return place_tree(tree, mesh, specs)


def local_shapes(tree) -> list:
    """The local shard shape of every leaf (a ``DTensor``'s ``to_local``,
    a plain tensor's own), in leaf order."""
    return [tuple((t.to_local() if isinstance(t, DTensor) else t).shape)
            for t in state_leaves(tree)]


def shard_shape(shape, spec, mesh) -> tuple:
    """The local shape of a tensor of ``shape`` placed by ``spec`` over
    ``mesh`` (either kind): each dimension divided by the sizes of the
    axes its entry names."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if spec is not None and i < len(spec) else None
        axes = e if isinstance(e, tuple) else ((e,) if e is not None else ())
        out.append(n // math.prod(sizes.get(a, 1) for a in axes))
    return tuple(out)


def opt_specs_from(params_specs, opt_abstract):
    """Optimizer-state specs: the moments inherit their parameter's spec;
    an int8 second moment ``{q, scale}`` (blocked ``(..., nb, 256)``) keeps
    the spec of the parameter's leading axes and leaves its two block axes
    unsharded. Filtered by the ambient mesh, as the reference's are."""
    def v_spec(leaf_spec, leaf):
        if isinstance(leaf, dict):
            base = tuple(leaf_spec) if leaf_spec is not None else ()
            spec = P(*base[:-1], None, None) if base else P(None, None)
            return {"q": _filter(spec, tuple(leaf["q"].shape)) or P(),
                    "scale": _filter(spec, tuple(leaf["scale"].shape)) or P()}
        return leaf_spec

    def walk(ps, v):
        if isinstance(v, dict) and set(v) == {"q", "scale"} and not isinstance(ps, dict):
            return v_spec(ps, v)
        if isinstance(ps, dict):
            return {k: walk(ps[k], v[k]) for k in sorted(ps)}
        if isinstance(ps, list):
            return [walk(a, b) for a, b in zip(ps, v)]
        return v_spec(ps, v)

    return {"m": params_specs, "v": walk(params_specs, opt_abstract["v"]), "count": P()}


def cache_specs(cfg, cache_abstract, shape):
    """KV and state cache specs under the ambient mesh. Normal decode (a
    batch of at least the data-parallel ranks): the batch over ``(pod,
    data)`` and an attention cache's SEQUENCE over ``model`` (flash-decode
    style: KV heads, 2 to 8, never divide a 16-way axis); a state cache's
    largest trailing dimension over ``model``. ``long_500k`` (batch 1): the
    attention cache's sequence over ``(data, model)``. ``shape`` needs only
    ``global_batch``."""
    long_ctx = shape.global_batch == 1
    mesh = get_abstract_mesh()
    axes = _names(mesh)
    sizes = mesh_axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp_n = math.prod(sizes[a] for a in dp)
    model_n = sizes.get("model", 1)

    def spec_for(leaf):
        shp = tuple(leaf.shape)
        nd = len(shp)
        entries = [None] * nd
        if nd >= 4 and cfg.n_kv_heads and shp[-2] == cfg.n_kv_heads:
            if not long_ctx and shp[1] % dp_n == 0:
                entries[1] = dp
            seq_axes = (("data",) if long_ctx else ()) + ("model",)
            seq_n = math.prod(sizes.get(a, 1) for a in seq_axes)
            if shp[-3] % seq_n == 0:
                entries[-3] = seq_axes
        else:
            if not long_ctx and nd >= 2 and shp[1] % dp_n == 0:
                entries[1] = dp
            big = max(range(2, nd), key=lambda i: shp[i]) if nd > 2 else None
            if big is not None and shp[big] % model_n == 0:
                entries[big] = "model"
        return P(*entries)

    return _map_spec_tree(lambda leaf, _: spec_for(leaf), cache_abstract, None)


def dp_size(mesh) -> int:
    """Ranks the batch is split over in the current mode (:func:`batch_axes`)."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in batch_axes())


def batch_shardings(mesh, batch_specs) -> dict:
    """A spec per batch entry: the batch dimension over the data-parallel
    axes of the mode where the ranks divide it, else replicated (a batch of
    one: long-context cells shard the cache instead)."""
    axes = _names(mesh)
    dp = tuple(a for a in batch_axes() if a in axes)
    out = {}
    for k, v in batch_specs.items():
        shp = tuple(v.shape)
        if shp and shp[0] > 1 and shp[0] % dp_size(mesh) == 0:
            out[k] = P(dp, *([None] * (len(shp) - 1)))
        else:
            out[k] = P(*([None] * len(shp)))
    return out
