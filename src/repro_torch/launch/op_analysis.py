"""Per-rank op-level cost analysis of one traced call. The counterpart of
``repro/launch/hlo_analysis.py``, which walks a compiled XLA module's HLO
text: a PyTorch program has no HLO, so this module watches the call itself
as it runs, one dispatched op at a time.

:class:`OpCounter` is a ``TorchDispatchMode``. An op on ``DTensor``
arguments is handed back to DTensor (the mode returns ``NotImplemented``),
which desugars it into the local op on each rank's shards and the
collectives its redistributions need; those come back through the mode on
plain (local) tensors. So every count is **per rank**, from local shapes,
as the reference's walker counts per chip:

  * ``flops``: the FLOPs of every matmul and convolution-like op, by
    PyTorch's own formulas (``torch.utils.flop_counter``). A loop in Python
    (chunked attention, the layer stack) runs its body once an iteration, so
    it is counted as the sum of its tiles, as the reference resolves its
    ``while`` trip counts;
  * ``bytes``: the reference's traffic model, operands plus result of each
    op (views, metadata and allocations move nothing);
  * ``collectives``: wire bytes a rank for the reference's five kinds (the
    bytes of the tensor a collective writes; an all-reduce counts twice, a
    ring's reduce-scatter plus all-gather), with ``count`` and ``total``.

DTensor infers an op's output metadata the first time it meets it by
running the op on fake tensors of the GLOBAL shapes; those calls are not
work any rank does, and the counter ignores them (it wraps DTensor's
``_propagate_tensor_meta_non_cached`` while it is active).

It also keeps the peak of live storages the call allocated
(:attr:`OpCounter.peak_bytes`) and, for every collective, the innermost
frame of this package that issued it (``models/layers.py:mlp``), the
counterpart of the HLO ``op_name`` that ``launch/attribution.py`` reads.

On meta (or fake) tensors and a ``fake`` process group
(:func:`repro_torch.launch.mesh.fake_production_mesh`) nothing is computed
or sent: the numbers are arithmetic over the traced shapes, not
measurements.
"""
from __future__ import annotations

import os
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# (namespace, op) -> the reference's collective kind; the functional
# collectives DTensor issues and the c10d ones of repro_torch.distributed
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# ops that move no bytes: views and metadata (as the reference skips its
# parameter, constant, bitcast, tuple and iota instructions), allocations,
# and a collective's wait
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "arange", "detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor",
         "device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size"}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _site() -> str:
    """The innermost frame of this package (this module aside) on the
    stack: ``path/in/package.py:function``."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(_ROOT) and path != _HERE:
            return f"{os.path.relpath(path, _ROOT)}:{frame.name}"
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it, per rank (see the module
    docstring). ``with OpCounter() as c: fn(...)``, then :meth:`report`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = 0
        self.sites = {}           # (kind, type, site) -> [repeats, wire bytes each]
        self._live = {}           # storage key -> [tensors alive, nbytes]
        self.live_bytes = 0
        self.peak_bytes = 0
        self._quiet = 0           # inside DTensor's metadata propagation
        self._restore = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def quiet(prop, *args, **kwargs):
            self._quiet += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._quiet -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = quiet
        self._restore = lambda: setattr(ShardingPropagator,
                                        "_propagate_tensor_meta_non_cached", orig)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    # ------------------------------------------------------------ memory

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            slot = self._live.get(key)
            if slot is None:
                slot = self._live[key] = [0, st.nbytes()]
                self.live_bytes += slot[1]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            slot[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        slot = self._live.get(key)
        if slot is None:
            return
        slot[0] -= 1
        if slot[0] <= 0:
            self.live_bytes -= slot[1]
            del self._live[key]

    # ---------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor desugars it into local ops and collectives
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:   # DTensor's global-shape metadata propagation
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in _COLL_NAMESPACES and name in _KINDS:
            kind = _KINDS[name]
            written = out if func.namespace != "c10d" else args[0]
            wire = _nbytes(written) * (2 if kind == "all-reduce" else 1)
            self.coll[kind] += wire
            self.coll_count += 1
            self.bytes += _nbytes(written)
            shape = [tuple(t.shape) for t in _tensors(written)]
            key = (kind, f"{_tensors(written)[0].dtype if shape else '?'}{shape}", _site())
            slot = self.sites.setdefault(key, [0, wire])
            slot[0] += 1
        else:
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if not (getattr(func, "is_view", False) or name in _FREE):
                self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self._track(out)
        return out

    # ----------------------------------------------------------- reports

    def report(self) -> dict:
        """The reference's ``analyze`` keys: ``flops``, ``bytes`` and
        ``collectives`` (the five kinds, ``count`` and ``total``)."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collectives": {**self.coll, "count": float(self.coll_count),
                            "total": float(sum(self.coll.values()))},
        }

    def collective_items(self) -> list:
        """``[(wire bytes x repeats, kind, type, repeats, site), ...]``,
        largest first, as the reference's attribution lists them."""
        items = [(wire * n, kind, typ, n, site)
                 for (kind, typ, site), (n, wire) in self.sites.items()]
        return sorted(items, key=lambda i: (-i[0], i[1], i[2], i[4]))


def analyze(fn, *args, **kwargs) -> dict:
    """Trace one call ``fn(*args, **kwargs)`` under an :class:`OpCounter`
    and return its per-rank ``flops``, ``bytes`` and ``collectives``."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.report()
