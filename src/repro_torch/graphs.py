"""CUDA graphs: the port's counterpart of the reference's compiled
executables (``jax.jit``). Each call on the main path -- a generator call
per (model, bucket) in :mod:`repro_torch.serve.gan_engine`, a decode step
in :mod:`repro_torch.serve.engine`, a training step in
:mod:`repro_torch.train.gan_trainer` -- is captured once and then replayed:
one launch from the host instead of a Python loop of launches.

:class:`CudaGraph` owns a static copy of its inputs and the outputs the
capture allocated. It runs the function once eagerly on a side stream
first, so that everything done once -- kernel builds, ``cudaFuncSetAttribute``,
cached geometries, cuBLAS and cuDNN handles and workspaces -- happens
outside the capture. A call copies the new inputs into the static ones and
replays. What the function closes over (parameters, a KV cache) is
captured by address: :func:`require_captured` holds callers to the objects
a graph was captured over. The outputs are the graph's own buffers, which
the next replay overwrites: a caller copies out what it keeps.

It is built on a CUDA device only. On the CPU the callers run their
functions eagerly, because the caller asked for the CPU; a capture that
fails raises and never falls back to eager launches.

The kernel wrappers count their launches in Python (``.launches``,
``.reduce_launches``, and ``epilogue_grad.folded_launches`` for the dx and
dw launches that apply its act'; :func:`repro_torch.kernels.wrappers`),
which a
replay would leave flat. :class:`LaunchCounters` takes the counts a
capture made back (the capture launched nothing on the card) and each
replay adds them again, so a counter counts what the card launched: eager
calls, the warm-up before a capture, and replays.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

COUNTERS = ("launches", "reduce_launches", "folded_launches")


class LaunchCounters:
    """The launch counters (:data:`COUNTERS`) of a set of kernel wrappers,
    read and written as one list in a fixed order."""

    def __init__(self, wrappers):
        self.slots = [(fn, name) for fn in wrappers for name in COUNTERS
                      if hasattr(fn, name)]

    def read(self) -> list:
        return [getattr(fn, name) for fn, name in self.slots]

    def write(self, values) -> None:
        for (fn, name), value in zip(self.slots, values):
            setattr(fn, name, value)

    def add(self, delta) -> None:
        self.write([a + d for a, d in zip(self.read(), delta)])

    def uncounted(self, run):
        """Call ``run()`` and take back the counts it added: ``(counts
        added, result)``. A capture runs every wrapper once and launches
        nothing; each replay then adds the counts (:meth:`add`)."""
        before = self.read()
        result = run()
        after = self.read()
        self.write(before)
        return [a - b for a, b in zip(after, before)], result


def kernel_counters() -> LaunchCounters:
    """The counters of the port's fourteen kernel wrappers
    (:func:`repro_torch.kernels.wrappers`)."""
    from repro_torch.kernels import wrappers

    return LaunchCounters(wrappers().values())


def require_captured(given, captured, what: str) -> None:
    """Raise ``ValueError`` unless ``given`` is the object a graph captured
    by address: a replay reads ``captured``'s memory whatever it is given,
    so any other object would be ignored (stale weights), and copying it in
    each call would move it all."""
    if given is not captured:
        raise ValueError(
            f"this executable replays a CUDA graph captured over its own "
            f"{what}; call it with that object, not another"
        )


class CudaGraph:
    """``fn(*inputs)`` captured once as a CUDA graph.

    ``inputs`` are trees (dicts, lists) of CUDA tensors; the graph keeps a
    static copy of each, in :attr:`inputs`. ``fn`` must not write into its
    inputs: its warm-up call runs on those copies and its outputs are
    dropped. ``pool`` (``torch.cuda.graph_pool_handle()``) lets graphs
    that never run at once share one memory pool; a replay of one of them
    may then overwrite the others' outputs too. :attr:`launches` is
    the per-replay count of each kernel counter (:func:`kernel_counters`).

    A call takes trees of tensors shaped like ``inputs`` (on the CPU or
    the card), copies each leaf that is not the static tensor itself into
    it, replays on the current stream and returns :attr:`outputs`, the
    buffers the next replay overwrites.
    """

    def __init__(self, fn, *inputs, pool=None):
        leaves = tree_leaves(list(inputs))
        if not leaves or not all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                                 for t in leaves):
            raise ValueError("a CUDA graph captures over CUDA tensors; on another "
                             "device the caller runs its function eagerly")
        device = leaves[0].device
        self.inputs = tree_map(torch.clone, list(inputs))
        self._static = tree_leaves(self.inputs)
        self._counters = kernel_counters()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(self.graph, pool=pool):
                return fn(*self.inputs)

        self.launches, self.outputs = self._counters.uncounted(capture)

    def __call__(self, *args):
        given = tree_leaves(list(args))
        if len(args) != len(self.inputs) or len(given) != len(self._static):
            raise ValueError(f"expected {len(self.inputs)} inputs of "
                             f"{len(self._static)} tensors, the captured structure")
        for arg, static in zip(given, self._static):
            if arg is static:
                continue
            if arg.shape != static.shape or arg.dtype != static.dtype:
                raise ValueError(f"a graph replays at its captured shapes: got "
                                 f"{tuple(arg.shape)} {arg.dtype}, captured "
                                 f"{tuple(static.shape)} {static.dtype}")
            static.copy_(arg)
        self.graph.replay()
        self._counters.add(self.launches)
        return self.outputs
