"""Measured per-layer method selection with a persistent cache. Mirrors
``repro/kernels/autotune.py``.

No rule of thumb picks the fastest of several mathematically identical
transpose-conv implementations on every shape, so the winner for a layer
shape is decided by timing the candidates on the machine at hand and
remembered. The cache keeps the reference's schema v4: one record per
layer signature (batch, N, n, Cin, Cout, P, dtype, epilogue) with a
direction each,

* ``fwd``  -- the forward race: the PyTorch baselines of
  :mod:`repro_torch.core.transpose_conv` (:data:`LAX_CANDIDATES`) and the
  hand-written kernels ``fused``, ``gemm`` and ``phase``; an epilogue'd
  layer also races ``fused+postops`` (the kernel bare, bias and activation
  composed after it), kept in the record and never the winner, as the
  reference keeps its backward's ``pallas+postops``;
* ``bwd``  -- ``segregated`` (the three backward kernels) against
  ``autograd`` (autograd of the ``unified`` form);
* ``step`` -- a full forward and backward per forward method, the backward
  as the ``bwd`` entry just recorded picks it;

and one record per adjacent-layer signature (``|pair|`` keys,
:func:`pair_key`) with a ``pair`` direction: the pair kernel (``pair``)
against the two layers run back to back as their serving plans run them.

Every candidate runs the whole layer ``act(tconv(x, W) + b)``. On the card
each is timed by replaying a CUDA graph of :data:`GRAPH_CALLS` calls
(:class:`~repro_torch.graphs.CudaGraph`) between two CUDA events, the
median of ``repeats``; a kernel that fails to build or launch there makes
the race raise. On the CPU the baselines race on host wall, and the
kernels, which run their plain versions there, are reported by their
roofline proxies and never win (the reference treats its interpreted
Pallas kernels so). The kernels' geometries are fixed by shape
(``fused_geometry``, ``gemm_geometry``, ``phase_geometry``,
``bwd_geometry``, ``pair_launch_geometry``), so no tile variant is raced:
an entry records its winner's ``summation_order`` where the reference
records tiles.

**The bucket rule** (a departure from the reference). A served sample must
be bitwise its unbatched call, so a serving consult reads no batch:
:func:`best_method` (``fwd``) and :func:`best_pair` resolve a signature to
one method for every batch recorded for it. Where the cache holds the
deployment's bucket histogram (:func:`record_traffic`, the batches a
serving window dispatched at each bucket as
:class:`~repro_torch.serve.metrics.ServeMetrics` counts them), the choice
is the candidate of least time weighted by it: the device time of that
traffic. Without one, it is the least time summed over the batches
recorded, but a winner that is slower than the cold rule's method at the
largest batch recorded does not replace it (the cold plan stands). Every
forward and pair race checks each candidate for batch invariance: each
sample of its batch (at b = 1, of a batch of :data:`INVARIANCE_BATCH`
drawn for the check) must be bitwise its batch-1 call. A candidate that fails is flagged in its entry's
``batch_variant`` list and cannot win the race or the serving choice. The
training consults (``step``, ``bwd``: :func:`best_entry`,
:func:`best_bwd`) read the batch, as the reference's do.

The cache lives at ``$REPRO_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json``. A key's backend field is
``torch_cuda`` for a race on the card and ``torch_cpu`` on the CPU (the
reference writes ``cpu``/``tpu``), so a file shared with the reference
serves neither package the other's records. v1-v3 files migrate on load;
another version is ignored, and set aside (``<file>.v<N>.bak``) on save;
records whose winner this build cannot dispatch are set aside on load and
written back as they were (:func:`known_winner_methods`); saves are atomic
renames; the view reloads when the file's mtime or size changes; a corrupt
file reads as an empty cache. The bucket histogram rides in the file's
``traffic`` field, one per backend. Every race appends one decision to
:mod:`repro_torch.obs.audit`'s trail.

The proxies (:func:`roofline_proxy`, :func:`gemm_roofline_proxy`,
:func:`bwd_roofline_proxy`, :func:`pair_roofline_proxy`,
:func:`back_to_back_proxy`) are ``max(flops / PEAK_FLOPS, bytes /
PEAK_BW)`` at the H100's fp32 and HBM rates: each operand read once and
each output written once, plus what a geometry adds in HBM (split partials
written and read back, a post-op pass, the interface a pair keeps on
chip); a staged tile's re-reads are taken to hit the 50 MB L2.

CLI::

    python -m repro_torch.kernels.autotune --gan-zoo [--train] [--batches 1 8]
    python -m repro_torch.kernels.autotune --layer 1 8 4 64 32 2 --repeats 2
    python -m repro_torch.kernels.autotune --pair 1 4 4 64 32 16 2
    python -m repro_torch.kernels.autotune --prune
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core import segregation as seg
from repro_torch.core import transpose_conv as tc
from repro_torch.device import resolve_device
from repro_torch.graphs import CudaGraph
from repro_torch.kernels import epilogue as epilib
from repro_torch.kernels import plan as planlib
from repro_torch.kernels import transpose_conv2d as fusedlib
from repro_torch.kernels import transpose_conv2d_bwd as bwdlib
from repro_torch.kernels import transpose_conv2d_gemm as gemmlib
from repro_torch.kernels import transpose_conv2d_pair as pairlib
from repro_torch.launch.roofline import HBM_BW as PEAK_BW
from repro_torch.launch.roofline import PEAK_FP32_FLOPS as PEAK_FLOPS
from repro_torch.obs import audit as obs_audit

# The proxies' rates (one H100 SXM: fp32 outside the tensor cores and HBM3)
# are the data-sheet peaks of launch/roofline.py.
GRAPH_CALLS = 20   # calls a timed CUDA graph replays, as PERF.md's "graph" µs
# the batch a batch-1 race checks its candidates' invariance at
INVARIANCE_BATCH = 4

_CACHE_VERSION = 4
_DIRECTIONS = ("fwd", "bwd", "step", "pair")
# what a well-formed v4 key looks like: a layer signature or a |pair|
# signature; --prune drops everything else
_KEY_RE = re.compile(
    r"^[A-Za-z0-9_]+\|b\d+\|n\d+\|k\d+\|ci\d+\|co\d+\|p\d+"
    r"\|[A-Za-z0-9_.]+\|e:[A-Za-z0-9.+_-]+$"
    r"|^[A-Za-z0-9_]+\|pair\|b\d+\|n\d+\|k\d+\|ci\d+\|mid\d+\|co\d+\|p\d+"
    r"\|[A-Za-z0-9_.]+\|e1:[A-Za-z0-9.+_-]+\|e2:[A-Za-z0-9.+_-]+$"
)
_BATCH_RE = re.compile(r"\|b(\d+)\|")
# In-memory view of the cache. "generation" bumps whenever the entries
# change (record, clear, prune, reload), so memoized plans resolve again;
# "alien" holds records whose winner this build cannot dispatch (written by
# a newer build): never served, written back on save; "traffic" holds the
# bucket histogram of each backend; "index" groups the records of one
# signature by batch for the serving consults.
_STATE: dict[str, Any] = {
    "path": None, "mtime": -1.0, "entries": {}, "alien": {}, "traffic": {},
    "generation": 0, "index": {}, "index_generation": -1,
}

# The reference's lax methods, here the PyTorch baselines; they race on
# wall clock on both devices.
LAX_CANDIDATES = (
    "conventional", "unified_reshape", "unified_matmul", "unified_fused",
)
KERNEL_CANDIDATES = ("fused", "phase", "gemm")
DEFAULT_CANDIDATES = LAX_CANDIDATES + KERNEL_CANDIDATES
# raced where the layer has an epilogue, kept in the record, never the winner
POSTOPS = "fused+postops"
BWD_CANDIDATES = ("segregated", "autograd")
PAIR_CANDIDATES = ("pair", "back_to_back")
# the reference's spellings of the port's kernel candidates
SPELLINGS = {**tc.KERNEL_METHODS, "pallas_pair": "pair"}


def cache_path() -> Path:
    p = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if p:
        return Path(p)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


def backend_of(device) -> str:
    """A key's backend field for a race on ``device``."""
    return "torch_cuda" if torch.device(device).type == "cuda" else "torch_cpu"


def default_backend() -> str:
    """The backend field a consult reads: the card's where one is present,
    as the reference reads ``jax.default_backend()``."""
    return backend_of("cuda" if torch.cuda.is_available() else "cpu")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tag(epi) -> str:
    epi = epilib.canonical(epi)
    return "none" if epi is None else epi.tag()


def layer_key(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype: str = "float32", backend: str | None = None, epilogue=None,
) -> str:
    backend = backend or default_backend()
    return (
        f"{backend}|b{b}|n{n_in}|k{n_k}|ci{cin}|co{cout}|p{padding}"
        f"|{_dtype_name(dtype)}|e:{_tag(epilogue)}"
    )


def pair_key(
    b: int, n_in: int, n_k: int, c0: int, c1: int, c2: int, padding: int,
    dtype: str = "float32", backend: str | None = None,
    *, epilogue1=None, epilogue2=None,
) -> str:
    """Cache key of an adjacent layer pair: ``(n_in, c0) -> c1 -> c2``, the
    producer's input dtype, the interface and output epilogues."""
    backend = backend or default_backend()
    return (
        f"{backend}|pair|b{b}|n{n_in}|k{n_k}|ci{c0}|mid{c1}|co{c2}"
        f"|p{padding}|{_dtype_name(dtype)}|e1:{_tag(epilogue1)}"
        f"|e2:{_tag(epilogue2)}"
    )


def _normalize(entry: dict) -> dict:
    """Flat v1-style entries become the ``fwd`` direction of a record."""
    if any(d in entry for d in _DIRECTIONS):
        return entry
    return {"fwd": entry}


def _migrate_key(key: str) -> str:
    """v1/v2 keys (no epilogue component) are the ``e:none`` signature."""
    return key if "|e:" in key else key + "|e:none"


def known_winner_methods(direction: str = "fwd") -> frozenset:
    """Winner names this build can dispatch for ``direction``: a record
    naming another (written by a newer build) is set aside on load."""
    if direction == "bwd":
        return frozenset(BWD_CANDIDATES)
    if direction == "pair":
        return frozenset(PAIR_CANDIDATES)
    return frozenset(planlib.METHODS)


def _record_is_native(rec) -> bool:
    if not isinstance(rec, dict):
        return False
    for d in _DIRECTIONS:
        e = rec.get(d)
        if (isinstance(e, dict) and e.get("method") is not None
                and e["method"] not in known_winner_methods(d)):
            return False
    return True


def _partition_native(entries: dict) -> tuple[dict, dict]:
    native, alien = {}, {}
    for k, rec in entries.items():
        (native if _record_is_native(rec) else alien)[k] = rec
    return native, alien


def _load() -> dict:
    """Reload the persistent cache if the file changed since the last read
    (its ``(st_mtime_ns, st_size)``)."""
    path = cache_path()
    if _STATE["path"] != str(path):
        _STATE.update(path=str(path), mtime=-1.0, entries={}, alien={},
                      traffic={})
        _STATE["generation"] += 1
    try:
        st = path.stat()
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        return _STATE["entries"]
    if sig != _STATE["mtime"]:
        try:
            blob = json.loads(path.read_text())
            if not isinstance(blob, dict):
                blob = {}   # valid JSON but not a cache: foreign
            traffic = {}
            if blob.get("version") in (_CACHE_VERSION, 3):
                loaded = blob.get("entries", {})   # v3 lacks only pair keys
                traffic = blob.get("traffic", {})
            elif blob.get("version") in (1, 2):
                loaded = {_migrate_key(k): _normalize(dict(e))
                          for k, e in blob.get("entries", {}).items()}
            else:   # a foreign version: pin none of its entries
                loaded = {}
            _STATE["entries"], _STATE["alien"] = _partition_native(loaded)
            _STATE["traffic"] = traffic if isinstance(traffic, dict) else {}
            _STATE["generation"] += 1
        except (json.JSONDecodeError, OSError):
            pass    # corrupt or unreadable: keep the in-memory view
        _STATE["mtime"] = sig
    return _STATE["entries"]


def _save() -> None:
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    try:   # never clobber another version's cache: set it aside
        prev = json.loads(path.read_text())
        ver = prev.get("version") if isinstance(prev, dict) else None
        if ver is not None and ver not in (1, 2, 3, _CACHE_VERSION):
            path.replace(path.with_name(path.name + f".v{ver}.bak"))
    except (json.JSONDecodeError, OSError):
        pass    # corrupt or missing: overwriting it loses nothing
    # set-aside records ride along; a key this build tuned again wins
    blob = {"version": _CACHE_VERSION,
            "entries": {**_STATE["alien"], **_STATE["entries"]}}
    if _STATE["traffic"]:
        blob["traffic"] = _STATE["traffic"]
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)   # atomic: concurrent tuners last-write-win
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    try:
        st = path.stat()
        _STATE["mtime"] = (st.st_mtime_ns, st.st_size)
    except OSError:
        pass


def lookup(key: str) -> dict | None:
    """The full per-direction record of ``key``."""
    return _load().get(key)


def record(key: str, entry: dict, *, direction: str | None = None,
           persist: bool = True) -> None:
    """Store ``entry`` for ``key``: ``direction=None`` replaces the record
    (a flat entry is its ``fwd`` direction), a direction merges that one."""
    _load()
    if direction is None:
        _STATE["entries"][key] = _normalize(entry)
    else:
        if direction not in _DIRECTIONS:
            raise ValueError(f"unknown direction {direction!r}")
        rec = dict(_STATE["entries"].get(key) or {})
        rec[direction] = entry
        _STATE["entries"][key] = rec
    _STATE["generation"] += 1
    if persist:
        _save()


def record_traffic(histogram: dict, *, backend: str | None = None,
                   persist: bool = True) -> None:
    """Store the deployment's bucket histogram, ``{bucket: batches
    dispatched at it}`` (a serving window's
    :attr:`~repro_torch.serve.metrics.ServeMetrics.bucket_batches`), for
    ``backend``'s serving consults to weight each recorded batch by. An
    empty histogram removes it."""
    _load()
    backend = backend or default_backend()
    hist = {str(int(b)): int(n) for b, n in histogram.items() if int(n) > 0}
    if hist:
        _STATE["traffic"][backend] = hist
    else:
        _STATE["traffic"].pop(backend, None)
    _STATE["generation"] += 1
    if persist:
        _save()


def traffic(backend: str | None = None) -> dict[int, int]:
    """The bucket histogram :func:`record_traffic` stored for
    ``backend``, ``{}`` if none."""
    _load()
    hist = _STATE["traffic"].get(backend or default_backend(), {})
    return {int(b): int(n) for b, n in hist.items()}


def clear_cache(*, memory_only: bool = False) -> None:
    _STATE.update(mtime=-1.0, entries={}, alien={}, traffic={})
    _STATE["generation"] += 1
    if not memory_only:
        try:
            cache_path().unlink()
        except OSError:
            pass


def prune_cache(*, persist: bool = True) -> list[str]:
    """Drop the entries whose key does not parse under schema v4; returns
    the dropped keys."""
    entries = _load()
    dropped = [k for k in entries if not _KEY_RE.match(k)]
    if dropped:
        for k in dropped:
            del entries[k]
        _STATE["generation"] += 1
        if persist:
            _save()
    return dropped


def generation() -> int:
    """A counter that changes whenever the cache's content changes: the
    memo key of :func:`repro_torch.kernels.plan.plan_layer_cached`."""
    _load()
    return _STATE["generation"]


def _batches_of(key: str) -> dict:
    """``{batch: record}`` of every entry that is ``key``'s signature at
    some batch."""
    entries = _load()
    if _STATE["index_generation"] != _STATE["generation"]:
        index: dict = {}
        for k, rec in entries.items():
            m = _BATCH_RE.search(k)
            if m:
                index.setdefault(_BATCH_RE.sub("|b*|", k, 1), {})[
                    int(m.group(1))] = rec
        _STATE["index"], _STATE["index_generation"] = index, _STATE["generation"]
    return _STATE["index"].get(_BATCH_RE.sub("|b*|", key, 1), {})


def _serving_choice(key: str, direction: str, cold: str) -> dict | None:
    """The bucket rule: one winner for every batch of ``key``'s signature,
    among the dispatchable candidates timed at every batch recorded and
    flagged batch-variant at none. With the backend's bucket histogram
    (:func:`traffic`) on a recorded batch, the least time weighted by it
    (``rule="traffic"``). Without one, the least time summed over the
    batches (``"sum"``), unless that winner is slower than ``cold`` (the
    cold rule's method) at the largest batch: then ``cold``
    (``"cold_guard"``). ``None`` when nothing qualifies (a cold miss)."""
    known = known_winner_methods(direction)
    per_batch, variant = {}, set()
    for b, rec in sorted(_batches_of(key).items()):
        e = rec.get(direction)
        if not isinstance(e, dict) or e.get("method") is None:
            continue
        cands = e.get("candidates") or {e["method"]: e.get("time_s", 0.0)}
        per_batch[b] = {m: float(t) for m, t in cands.items()
                        if m in known and isinstance(t, (int, float))}
        variant |= set(e.get("batch_variant", ()))
    if not per_batch:
        return None
    timed = set.intersection(*(set(t) for t in per_batch.values())) - variant
    if not timed:
        return None
    hist = traffic(key.split("|", 1)[0])
    weights = {b: hist.get(b, 0) for b in per_batch}
    rule = "traffic" if sum(weights.values()) > 0 else "sum"
    if rule == "sum":
        weights = dict.fromkeys(per_batch, 1)
    totals = {m: sum(weights[b] * per_batch[b][m] for b in per_batch)
              for m in timed}
    winner = min(sorted(totals), key=totals.get)
    top = per_batch[max(per_batch)]
    if rule == "sum" and cold in totals and top[winner] > top[cold]:
        winner, rule = cold, "cold_guard"
    entry = {"method": winner, "time_s": totals[winner], "source": "tuned",
             "rule": rule, "batches": sorted(per_batch), "candidates": totals}
    if rule == "traffic":
        entry["weights"] = weights
    if variant:
        entry["batch_variant"] = sorted(variant)
    return entry


def best_entry(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype: str = "float32", *, epilogue=None,
) -> dict | None:
    """Cache-only consult: the full per-direction record at batch ``b``."""
    return lookup(layer_key(b, n_in, n_k, cin, cout, padding, dtype,
                            epilogue=epilogue))


def best_method(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype: str = "float32", *, epilogue=None,
) -> dict | None:
    """The serving consult of the forward: the signature's one winner over
    every batch recorded (the bucket rule; ``b`` is not read), or None."""
    return _serving_choice(layer_key(b, n_in, n_k, cin, cout, padding, dtype,
                                     epilogue=epilogue), "fwd",
                           planlib.cold_method(n_in, n_k, padding))


def best_bwd(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int,
    dtype: str = "float32", *, epilogue=None,
) -> dict | None:
    """Cache-only consult: the ``bwd`` entry at batch ``b``, or None."""
    rec = best_entry(b, n_in, n_k, cin, cout, padding, dtype, epilogue=epilogue)
    return rec.get("bwd") if rec else None


def best_pair(
    b: int, n_in: int, n_k: int, c0: int, c1: int, c2: int, padding: int,
    dtype: str = "float32", *, epilogue1=None, epilogue2=None,
) -> dict | None:
    """The serving consult of a pair (what ``fuse="auto"`` reads): the
    pair signature's one winner over every batch recorded (``b`` is not
    read), or None. The pair fuses iff the winner is ``pair``."""
    return _serving_choice(pair_key(b, n_in, n_k, c0, c1, c2, padding, dtype,
                                    epilogue1=epilogue1, epilogue2=epilogue2),
                           "pair", "back_to_back")


# ------------------------------------------------------------------ roofline

def _seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BW)


def _epi_flops(epi, b: int, m: int, cout: int) -> int:
    epi = epilib.canonical(epi)
    if epi is None:
        return 0
    return (int(epi.bias) + int(epi.act != "none")) * b * m * m * cout


def _partials(splits: int, elems: int) -> int:
    """Bytes of split partials: written once and read back once."""
    return 2 * splits * elems * 4 if splits > 1 else 0


def epilogue_postop_bytes(b: int, m: int, cout: int) -> int:
    """The extra pass of a bias + activation run as post-ops: the fp32
    output read back and the activated map written."""
    return 2 * b * m * m * cout * 4


def _layer_bytes(b, n_in, m, cin, cout, n_k, dtype_bytes) -> int:
    """A layer's compulsory traffic: x and W read once, the fp32 output
    written once."""
    return ((b * n_in * n_in * cin + n_k * n_k * cin * cout) * dtype_bytes
            + b * m * m * cout * 4)


def roofline_proxy(
    method: str, b: int, n_in: int, n_k: int, cin: int, cout: int,
    padding: int = 0, *, dtype_bytes: int = 4, epilogue=None,
    fuse_epilogue: bool = True,
) -> float:
    """Seconds of the fused (``"fused"``) or per-phase (``"phase"``)
    kernel at the H100's rates: the segregated MACs, and the layer's
    compulsory bytes plus the Cin split partials its geometry writes and
    reads back (the staged windows' re-reads are taken to hit L2).
    ``fuse_epilogue=False`` adds the post-op pass."""
    if method == "fused":
        splits = fusedlib.fused_geometry(b, n_in, n_k, padding, cin, cout).splits
    elif method == "phase":
        splits = fusedlib.phase_geometry(b, n_in, n_k, padding, cin, cout).splits
    else:
        raise ValueError(f"no roofline model for method {method!r}")
    m = seg.output_size(n_in, n_k, padding)
    flops = 2 * b * seg.flop_count(n_in, n_k, cin, cout, padding)
    flops += _epi_flops(epilogue, b, m, cout)
    nbytes = _layer_bytes(b, n_in, m, cin, cout, n_k, dtype_bytes)
    nbytes += _partials(splits, b * m * m * cout)
    if epilib.canonical(epilogue) is not None and not fuse_epilogue:
        nbytes += epilogue_postop_bytes(b, m, cout)
    return _seconds(flops, nbytes)


def gemm_roofline_proxy(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int = 0,
    *, dtype_bytes: int = 4, epilogue=None,
) -> float:
    """Seconds of the implicit-GEMM kernel: each parity's dense GEMM over
    its ``B Hp Hp`` rows and ``R x R`` taps (an odd ``M`` over-computes a
    row and a column), the compulsory bytes and the contraction split's
    partials."""
    g = gemmlib.gemm_geometry(b, n_in, n_k, padding, cin, cout)
    flops = 2 * 4 * g.rows * g.r * g.r * cin * cout
    flops += _epi_flops(epilogue, b, g.m, cout)
    nbytes = _layer_bytes(b, n_in, g.m, cin, cout, n_k, dtype_bytes)
    nbytes += _partials(g.splits, b * g.m * g.m * cout)
    return _seconds(flops, nbytes)


def bwd_roofline_proxy(
    method: str, b: int, n_in: int, n_k: int, cin: int, cout: int,
    padding: int = 0, *, dtype_bytes: int = 4, epilogue=None,
) -> float:
    """Seconds of a layer's backward (dx, dW and db).

    ``"segregated"``: the segregated MACs of dx and of dW; g, W, x read
    and dx, dW written once, and y read by both kernels where the epilogue
    has an activation (they apply act' as they stage g); the dx and dw
    split partials of
    :func:`~repro_torch.kernels.transpose_conv2d_bwd.bwd_geometry`.

    ``"autograd"``: autograd of the ``unified`` form: each phase
    convolution's input gradient over-computes into the ``R - 1`` zero
    frame; the parity planes of g extracted, four dx partials written and
    added, dW written and read back, the act' mask and db as passes of
    their own.
    """
    m = seg.output_size(n_in, n_k, padding)
    R = seg.ceil_half(n_k)
    hp = (m + 1) // 2
    macs2 = 2 * b * seg.flop_count(n_in, n_k, cin, cout, padding)
    epi = epilib.canonical(epilogue)
    g_plane = b * m * m * cout * 4
    x_b = b * n_in * n_in * cin * dtype_bytes
    dx_elems, dw_elems = b * n_in * n_in * cin, n_k * n_k * cin * cout
    if method == "segregated":
        g = bwdlib.bwd_geometry(b, n_in, n_k, padding, cin, cout)
        flops = 2 * macs2
        nbytes = (2 * g_plane + 2 * dw_elems * 4 + x_b + dx_elems * 4
                  + _partials(g.dx_splits, dx_elems)
                  + _partials(g.dw_splits, dw_elems))
        if epi is not None and epi.act != "none":
            nbytes += 2 * g_plane
    elif method == "autograd":
        over = ((hp + R - 1) / hp) ** 2
        flops = (1 + over) * macs2
        plane_b = b * hp * hp * cout * 4
        nbytes = (2 * g_plane + 4 * 2 * plane_b + 4 * 2 * dx_elems * 4
                  + 4 * x_b + 3 * 4 * R * R * cin * cout * 4)
        if epi is not None and epi.act != "none":
            nbytes += 5 * g_plane
        elif epi is not None and epi.bias:
            nbytes += g_plane
    else:
        raise ValueError(f"no backward roofline model for method {method!r}")
    return _seconds(flops, nbytes)


def pair_roofline_proxy(
    b: int, n_in: int, n_k: int, c0: int, c1: int, c2: int,
    padding: int = 0, *, dtype_bytes: int = 4, epilogue1=None, epilogue2=None,
) -> float:
    """Seconds of the pair kernel: both layers' segregated MACs; x, W1 and
    W2 read once and the pair's output written once. The interface never
    leaves the cluster's shared memory, and the kernel has no split."""
    m1 = seg.output_size(n_in, n_k, padding)
    m2 = seg.output_size(m1, n_k, padding)
    flops = 2 * b * (seg.flop_count(n_in, n_k, c0, c1, padding)
                     + seg.flop_count(m1, n_k, c1, c2, padding))
    flops += _epi_flops(epilogue1, b, m1, c1) + _epi_flops(epilogue2, b, m2, c2)
    nbytes = ((b * n_in * n_in * c0 + n_k * n_k * (c0 * c1 + c1 * c2))
              * dtype_bytes + b * m2 * m2 * c2 * 4)
    return _seconds(flops, nbytes)


def _layer_proxy(method, b, n_in, n_k, cin, cout, padding, epilogue) -> float:
    if method == "gemm":
        return gemm_roofline_proxy(b, n_in, n_k, cin, cout, padding,
                                   epilogue=epilogue)
    return roofline_proxy(method, b, n_in, n_k, cin, cout, padding,
                          epilogue=epilogue)


def back_to_back_proxy(
    b: int, n_in: int, n_k: int, c0: int, c1: int, c2: int,
    padding: int = 0, *, epilogue1=None, epilogue2=None,
) -> float:
    """Seconds of the two layers as two launches of the kernels the cold
    rule picks, the interface written and read back through HBM."""
    m1 = seg.output_size(n_in, n_k, padding)
    return (_layer_proxy(planlib.cold_method(n_in, n_k, padding), b, n_in,
                         n_k, c0, c1, padding, epilogue1)
            + _layer_proxy(planlib.cold_method(m1, n_k, padding), b, m1, n_k,
                           c1, c2, padding, epilogue2))


# ------------------------------------------------------------------- timing

def _times_kernels(device: torch.device) -> bool:
    """Whether the hand-written kernels race on wall clock on ``device``:
    on the card; on the CPU they run their plain versions, which say
    nothing of the kernels' speed."""
    return device.type == "cuda"


def _time(fn, *args, repeats: int, warmup: int) -> float:
    """Seconds per call of ``fn(*args)``. On the card: a CUDA graph of
    :data:`GRAPH_CALLS` calls, its replay between two CUDA events, the
    median of ``repeats`` replays after ``warmup`` more. On the CPU: the
    median host wall of ``repeats`` calls after ``warmup``."""
    if args[0].device.type == "cuda":
        graph = CudaGraph(lambda *a: [fn(*a) for _ in range(GRAPH_CALLS)], *args)
        for _ in range(warmup):
            graph(*graph.inputs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ts = []
        for _ in range(repeats):
            start.record()
            graph(*graph.inputs)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3 / GRAPH_CALLS)
        return float(np.median(ts))
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _batch_variant(fn, *args) -> bool:
    """Whether some sample of ``fn(*args)`` (the batch on ``args[0]``'s
    first axis) differs in any bit from ``fn`` called on that sample
    alone."""
    full = fn(*args)
    return any(not torch.equal(full[i : i + 1], fn(args[0][i : i + 1], *args[1:]))
               for i in range(args[0].shape[0]))


# ------------------------------------------------------------------- tuning

def _layer_fn(padding: int, name: str, epi, bwd: str = "segregated"):
    """``fn(x, k[, b])``: the whole layer ``act(tconv(x, k) + b)`` through a
    plan pinned to ``name``, executed as dispatch executes it;
    ``fused+postops``: the fused kernel's bare plan, the epilogue composed
    after it."""
    base, epi_in = ("fused", None) if name == POSTOPS else (name, epi)

    def fn(x, k, bvec=None):
        lp = planlib.plan_layer(x.shape[0], x.shape[1], k.shape[0], k.shape[2],
                                k.shape[3], padding, x.dtype, method=base,
                                epilogue=epi_in, bwd=bwd)
        if name == POSTOPS:
            return epi.apply(planlib.execute_layer(lp, x, k), bvec)
        return planlib.execute_layer(lp, x, k, bias=bvec)

    return fn


def summation_order(method: str, b, n_in, n_k, cin, cout, padding) -> list:
    """The geometry fields that fix the order of every output's sum of a
    kernel ``method``: what an entry records where the reference records
    tiles."""
    if method == "fused":
        g = fusedlib.fused_geometry(b, n_in, n_k, padding, cin, cout)
    elif method == "phase":
        g = fusedlib.phase_geometry(b, n_in, n_k, padding, cin, cout)
    elif method == "gemm":
        g = gemmlib.gemm_geometry(b, n_in, n_k, padding, cin, cout)
    elif method == "segregated":
        g = bwdlib.bwd_geometry(b, n_in, n_k, padding, cin, cout)
        return [g.dx_layout, g.dx_splits, g.dw_layout, g.dw_splits]
    else:
        raise ValueError(f"no kernel geometry for {method!r}")
    return list(g.summation_order)


def _entry(candidates: dict, variant: set, **extra) -> dict:
    """A race's entry: the fastest dispatchable candidate not flagged
    batch-variant (``fused+postops`` stays in the record only)."""
    eligible = {m: t for m, t in candidates.items()
                if m not in variant and m != POSTOPS}
    if not eligible:
        raise RuntimeError(
            f"every candidate of the race depends on the batch: {sorted(variant)}")
    winner = min(eligible, key=eligible.get)
    entry = {"method": winner, "time_s": eligible[winner], "source": "measured",
             "candidates": candidates, **extra}
    if variant:
        entry["batch_variant"] = sorted(variant)
    return entry


def _tune_fwd(x, xc, k, bvec, padding, methods, with_kernels, repeats, warmup,
              epi):
    """The forward race; ``xc`` is the batch each candidate's invariance
    is checked on (``x`` itself at b > 1)."""
    b, n_in, _, cin = x.shape
    n_k, cout = k.shape[0], k.shape[3]
    sig = (b, n_in, n_k, cin, cout, padding)
    args = (x, k, bvec) if epi is not None and epi.bias else (x, k)
    proxy = {"fused": roofline_proxy("fused", *sig, epilogue=epi),
             "phase": roofline_proxy("phase", *sig, epilogue=epi),
             "gemm": gemm_roofline_proxy(*sig, epilogue=epi)}
    if epi is not None:
        proxy[POSTOPS] = roofline_proxy("fused", *sig, epilogue=epi,
                                        fuse_epilogue=False)
    timed = [m for m in methods if m in LAX_CANDIDATES]
    if with_kernels:
        timed += [m for m in methods if m in KERNEL_CANDIDATES]
        if epi is not None and "fused" in timed:
            timed.append(POSTOPS)
    candidates, variant = {}, set()
    for name in timed:
        fn = _layer_fn(padding, name, epi)
        candidates[name] = _time(fn, *args, repeats=repeats, warmup=warmup)
        if _batch_variant(fn, xc, *args[1:]):
            variant.add(name)
    entry = _entry(candidates, variant, proxy=proxy)
    if entry["method"] in KERNEL_CANDIDATES:
        entry["summation_order"] = summation_order(entry["method"], *sig)
    return entry


def _tune_bwd(x, k, bvec, padding, with_kernels, repeats, warmup, epi):
    from repro_torch.kernels.ops import _autograd_bwd

    b, n_in, _, cin = x.shape
    n_k, cout = k.shape[0], k.shape[3]
    sig = (b, n_in, n_k, cin, cout, padding)
    m = seg.output_size(n_in, n_k, padding)
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.normal(size=(b, m, m, cout)), dtype=torch.float32,
                        device=x.device)
    # an activation's backward reads the saved forward output y
    y = None
    if epi is not None and epi.act != "none":
        y = _layer_fn(padding, "unified_reshape", epi)(x, k, bvec)

    def autograd(x, k, g):
        return _autograd_bwd(x, k, y, g, padding, epi, True)

    def segregated(x, k, g):
        return bwdlib.transpose_conv2d_bwd(x, k, g, padding, epilogue=epi, y=y,
                                           need_dx=True)

    proxy = {name: bwd_roofline_proxy(name, *sig, epilogue=epi)
             for name in BWD_CANDIDATES}
    candidates = {"autograd": _time(autograd, x, k, g, repeats=repeats,
                                    warmup=warmup)}
    if with_kernels:
        candidates["segregated"] = _time(segregated, x, k, g, repeats=repeats,
                                         warmup=warmup)
    entry = _entry(candidates, set(), proxy=proxy)
    if entry["method"] == "segregated":
        entry["summation_order"] = summation_order("segregated", *sig)
    return entry


def _tune_step(x, k, bvec, padding, methods, with_kernels, repeats, warmup, epi):
    """A full forward and backward per forward method: gradients of
    ``layer(x, k[, b]).sum()`` in every input. The kernels differentiate
    through the ``bwd`` entry just recorded (``bwd="auto"``), the joint
    choice training dispatch makes."""
    b, n_in, _, cin = x.shape
    n_k, cout = k.shape[0], k.shape[3]
    timed = [m for m in methods if m in LAX_CANDIDATES]
    if with_kernels:
        timed += [m for m in methods if m in KERNEL_CANDIDATES]
        if epi is not None and "fused" in timed:
            timed.append(POSTOPS)
    args = (x, k, bvec) if epi is not None and epi.bias else (x, k)
    candidates = {}
    for name in timed:
        fn = _layer_fn(padding, name, epi, bwd="auto")

        def step(*a, _fn=fn):
            leaves = [t.detach().requires_grad_(True) for t in a]
            with torch.enable_grad():
                return torch.autograd.grad(_fn(*leaves).sum(), leaves)

        candidates[name] = _time(step, *args, repeats=repeats, warmup=warmup)
    entry = _entry(candidates, set())
    if entry["method"] in KERNEL_CANDIDATES:
        entry["summation_order"] = summation_order(
            entry["method"], b, n_in, n_k, cin, cout, padding)
    return entry


def _fwd_methods(methods) -> tuple:
    """The forward candidates to race, the reference's spellings mapped to
    the port's names."""
    if methods is None:
        return DEFAULT_CANDIDATES
    out = tuple(dict.fromkeys(SPELLINGS.get(m, m) for m in methods))
    unknown = sorted(set(out) - set(DEFAULT_CANDIDATES))
    if unknown:
        raise ValueError(f"unknown method(s) {unknown}; valid: {DEFAULT_CANDIDATES}")
    return out


def _audit(kind, key, direction, entry, backend, persist) -> None:
    obs_audit.get_trail().record_decision(kind=kind, key=key,
                                          direction=direction, entry=entry,
                                          backend=backend, persist=persist)


def tune_layer(
    b: int, n_in: int, n_k: int, cin: int, cout: int, padding: int = 0,
    *, dtype=torch.float32, methods: tuple | None = None, repeats: int = 3,
    warmup: int = 1, persist: bool = True, train: bool = False,
    epilogue=None, device=None,
) -> dict:
    """Race the candidates of one layer shape on ``device`` (the card
    unless the caller names another), record the entries and return the
    layer's record.

    ``methods`` filters the forward candidates (default: the four
    baselines and the three kernels; the reference's ``pallas_*`` names
    are taken). ``train=True`` also races ``bwd`` and then ``step``.
    ``epilogue`` makes ``act(tconv + b)`` the tuned unit, its own
    signature. Inputs are drawn from seed 0, as the reference draws them.
    """
    dev = resolve_device(device)
    backend = backend_of(dev)
    epilogue = epilib.canonical(epilogue)
    methods = _fwd_methods(methods)
    with_kernels = _times_kernels(dev)
    if not with_kernels and not set(methods) & set(LAX_CANDIDATES):
        raise ValueError(
            f"nothing to time: methods={methods} names only the hand-written "
            f"kernels, which a {dev.type} tensor runs through their plain "
            "versions (add a baseline, or race on the card)"
        )
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(b, n_in, n_in, cin)), dtype=dtype).to(dev)
    k = torch.as_tensor(rng.normal(size=(n_k, n_k, cin, cout)) * 0.05,
                        dtype=dtype).to(dev)
    bvec = None
    if epilogue is not None and epilogue.bias:
        bvec = torch.as_tensor(rng.normal(size=(cout,)) * 0.1, dtype=dtype).to(dev)
    xc = x if b > 1 else torch.as_tensor(
        rng.normal(size=(INVARIANCE_BATCH, n_in, n_in, cin)), dtype=dtype).to(dev)
    key = layer_key(b, n_in, n_k, cin, cout, padding, dtype, backend,
                    epilogue=epilogue)
    fwd = _tune_fwd(x, xc, k, bvec, padding, methods, with_kernels, repeats,
                    warmup, epilogue)
    # one disk write per tune_layer: earlier directions wait in memory
    record(key, fwd, direction="fwd", persist=persist and not train)
    _audit("layer", key, "fwd", fwd, backend, persist)
    if not train:
        return lookup(key)
    # bwd before step: the step race's kernels differentiate through it
    bwd = _tune_bwd(x, k, bvec, padding, with_kernels, repeats, warmup, epilogue)
    record(key, bwd, direction="bwd", persist=False)
    _audit("layer", key, "bwd", bwd, backend, persist)
    step = _tune_step(x, k, bvec, padding, methods, with_kernels, repeats,
                      warmup, epilogue)
    record(key, step, direction="step", persist=persist)
    _audit("layer", key, "step", step, backend, persist)
    return lookup(key)


def tune_pair(
    b: int, n_in: int, n_k: int, c0: int, c1: int, c2: int, padding: int = 0,
    *, dtype=torch.float32, methods: tuple | None = None, repeats: int = 3,
    warmup: int = 1, persist: bool = True, epilogue1=None, epilogue2=None,
    device=None,
) -> dict:
    """Race the pair kernel against the two layers back to back (each as
    its serving plan runs it now), each checked for batch invariance as the
    forward race checks its candidates, for one pair that
    :func:`~repro_torch.kernels.plan.pair_legal` allows, on ``device``
    (the card unless the caller names another); record and return the
    ``pair`` entry's record. On the CPU neither candidate is a kernel's
    time, so the entry is the proxies' with ``source="proxy"`` and the
    ``back_to_back`` winner: a plain version never makes a pair fuse."""
    dev = resolve_device(device)
    backend = backend_of(dev)
    epi1, epi2 = epilib.canonical(epilogue1), epilib.canonical(epilogue2)
    methods = tuple(dict.fromkeys(SPELLINGS.get(m, m)
                                  for m in methods or PAIR_CANDIDATES))
    unknown = sorted(set(methods) - set(PAIR_CANDIDATES))
    if unknown:
        raise ValueError(f"unknown pair method(s) {unknown}; valid: {PAIR_CANDIDATES}")
    m1 = seg.output_size(n_in, n_k, padding)
    lp1 = planlib.plan_layer(b, n_in, n_k, c0, c1, padding, dtype, epilogue=epi1)
    lp2 = planlib.plan_layer(b, m1, n_k, c1, c2, padding, dtype, epilogue=epi2)
    ok, why = planlib.pair_legal(lp1, lp2)
    if not ok:
        raise ValueError(f"pair {n_in}x{n_in}x{c0}->{c1}->{c2} cannot fuse: {why}")
    key = pair_key(b, n_in, n_k, c0, c1, c2, padding, dtype, backend,
                   epilogue1=epi1, epilogue2=epi2)
    sig = (b, n_in, n_k, c0, c1, c2, padding)
    proxy = {"pair": pair_roofline_proxy(*sig, epilogue1=epi1, epilogue2=epi2),
             "back_to_back": back_to_back_proxy(*sig, epilogue1=epi1,
                                                epilogue2=epi2)}
    if not _times_kernels(dev):
        entry = {"method": "back_to_back", "time_s": proxy["back_to_back"],
                 "source": "proxy", "candidates": {}, "proxy": proxy}
    else:
        rng = np.random.default_rng(0)

        def draw(*shape, scale=1.0):
            return torch.as_tensor(rng.normal(size=shape) * scale,
                                   dtype=dtype).to(dev)

        args = (draw(b, n_in, n_in, c0), draw(n_k, n_k, c0, c1, scale=0.05),
                draw(n_k, n_k, c1, c2, scale=0.05), draw(c1, scale=0.1),
                draw(c2, scale=0.1))
        xc = args[0] if b > 1 else draw(INVARIANCE_BATCH, n_in, n_in, c0)

        def pair(x, k1, k2, b1, b2):
            return pairlib.transpose_conv2d_pair(
                x, k1, k2, padding, epilogue1=epi1, bias1=b1, epilogue2=epi2,
                bias2=b2)

        def back_to_back(x, k1, k2, b1, b2):
            lpa = planlib.plan_layer(x.shape[0], n_in, n_k, c0, c1, padding,
                                     dtype, epilogue=epi1)
            lpb = planlib.plan_layer(x.shape[0], m1, n_k, c1, c2, padding,
                                     dtype, epilogue=epi2)
            y1 = planlib.execute_layer(lpa, x, k1, bias=b1)
            return planlib.execute_layer(lpb, y1, k2, bias=b2)

        fns = {"pair": pair, "back_to_back": back_to_back}
        candidates, variant = {}, set()
        for name in methods:
            candidates[name] = _time(fns[name], *args, repeats=repeats,
                                     warmup=warmup)
            if _batch_variant(fns[name], xc, *args[1:]):
                variant.add(name)
        entry = _entry(candidates, variant, proxy=proxy)
        if entry["method"] == "pair":
            L = pairlib.pair_launch_geometry(n_in, n_k, padding, c0, c1, c2)
            entry["summation_order"] = [L.r, L.d, L.ks1, L.ks2, L.nst1, L.nst2]
    record(key, entry, direction="pair", persist=persist)
    _audit("pair", key, "pair", entry, backend, persist)
    return lookup(key)


def tune_gan_zoo(
    *, batches=(1,), repeats: int = 3, persist: bool = True,
    train: bool = False, epilogues: bool = True, pairs: bool = True,
    methods: tuple | None = None, configs=None, device=None,
) -> dict[str, dict]:
    """Tune every distinct layer of the Table-4 generators (``configs``,
    default all four) at each batch of ``batches``; returns ``{key:
    record}``.

    ``epilogues=True`` tunes the signatures the generators dispatch, each
    layer with its bias + activation; ``False`` the bare ones. ``pairs``
    (with ``epilogues``) then races every pair the plan pass would consult:
    the pairs of ``fuse="force"``'s plan, after every layer at every batch,
    so that each back-to-back candidate runs its layers' serving choice.
    """
    from repro_torch.models.gan import GAN_ZOO, generator_epilogues

    configs = tuple(configs or GAN_ZOO.values())
    backend = backend_of(resolve_device(device))
    out, seen = {}, set()
    for batch in batches:
        for cfg in configs:
            epis = (generator_epilogues(cfg) if epilogues
                    else (None,) * len(cfg.layers))
            for (hw, cin, cout), epi in zip(cfg.layers, epis):
                sig = (batch, hw, cfg.kernel, cin, cout, cfg.padding)
                if (sig, epi) in seen:
                    continue
                seen.add((sig, epi))
                out[layer_key(*sig, backend=backend, epilogue=epi)] = tune_layer(
                    *sig, repeats=repeats, persist=persist, train=train,
                    epilogue=epi, methods=methods, device=device)
    if not (pairs and epilogues):
        return out
    for batch in batches:
        for cfg in configs:
            plan = planlib.compile_plan(cfg, batch,
                                        epilogues=generator_epilogues(cfg),
                                        fuse="force")
            for e in plan.entries:
                if not isinstance(e, planlib.FusedPairPlan):
                    continue
                a, z = e.first, e.second
                sig = (batch, a.n_in, a.n_k, a.cin, a.cout, z.cout, a.padding)
                if (sig, a.epilogue, z.epilogue) in seen:
                    continue
                seen.add((sig, a.epilogue, z.epilogue))
                out[pair_key(*sig, backend=backend, epilogue1=a.epilogue,
                             epilogue2=z.epilogue)] = (
                    tune_pair(*sig, repeats=repeats, persist=persist,
                              epilogue1=a.epilogue, epilogue2=z.epilogue,
                              device=device))
    return out


def main(argv=None):
    """CLI: populate (or clean) the persistent cache.

    python -m repro_torch.kernels.autotune --gan-zoo [--train] [--batches 1 2 4 8]
    python -m repro_torch.kernels.autotune --layer 1 8 4 512 256 2
    python -m repro_torch.kernels.autotune --layer 8 4 4 1024 512 2 --methods gemm,fused
    python -m repro_torch.kernels.autotune --pair 1 8 4 512 256 128 2
    python -m repro_torch.kernels.autotune --prune

    Races run on the card where one is present, else on the CPU (the
    baselines only; the kernels by proxy); ``--device`` names it.
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--gan-zoo", action="store_true",
                   help="tune every distinct Table-4 GAN layer (with the "
                        "generator epilogues by default) and the pairs the "
                        "plan pass would fuse")
    g.add_argument("--layer", nargs=6, type=int,
                   metavar=("B", "N", "K", "CIN", "COUT", "PAD"))
    g.add_argument("--pair", nargs=7, type=int,
                   metavar=("B", "N", "K", "CIN", "CMID", "COUT", "PAD"),
                   help="race the pair kernel against the two layers back to "
                        "back (relu-bias interface and tanh-bias output)")
    g.add_argument("--prune", action="store_true",
                   help="drop cache entries whose key no longer parses under "
                        "the current schema version")
    ap.add_argument("--train", action="store_true",
                    help="also tune the bwd and full-train-step directions")
    ap.add_argument("--no-epilogue", action="store_true",
                    help="tune bare transpose-conv signatures (no bias and "
                         "activation)")
    ap.add_argument("--methods",
                    help="comma-separated candidate filter, e.g. "
                         "--methods gemm,fused (pallas_* spellings taken)")
    ap.add_argument("--batches", nargs="+", type=int, default=[1],
                    help="--gan-zoo: the batches to tune each layer at")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="where to race (default: the card if present, else "
                         "the CPU)")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")

    methods = pair_methods = None
    if args.methods:
        names = tuple(SPELLINGS.get(s.strip(), s.strip())
                      for s in args.methods.split(",") if s.strip())
        valid = DEFAULT_CANDIDATES + PAIR_CANDIDATES
        unknown = sorted(set(names) - set(valid))
        if unknown:
            ap.error(f"unknown method(s): {', '.join(unknown)}; "
                     f"valid: {', '.join(valid)}")
        methods = tuple(m for m in names if m in DEFAULT_CANDIDATES) or None
        pair_methods = tuple(m for m in names if m in PAIR_CANDIDATES) or None

    if args.prune:
        dropped = prune_cache()
        print(f"# cache: {cache_path()}")
        for k in dropped:
            print(f"pruned {k}")
        print(f"# pruned {len(dropped)} unparsable "
              f"entr{'y' if len(dropped) == 1 else 'ies'} "
              f"(schema v{_CACHE_VERSION})")
        return

    epi1 = epi2 = None
    if not args.no_epilogue:
        epi1 = epilib.make(True, "relu")
        epi2 = epilib.make(True, "tanh")
    if args.gan_zoo:
        entries = tune_gan_zoo(batches=args.batches, repeats=args.repeats,
                               train=args.train, epilogues=not args.no_epilogue,
                               methods=methods, device=device)
    elif args.pair:
        tune_pair(*args.pair, repeats=args.repeats, methods=pair_methods,
                  epilogue1=epi1, epilogue2=epi2, device=device)
        key = pair_key(*args.pair, backend=backend_of(device), epilogue1=epi1,
                       epilogue2=epi2)
        entries = {key: lookup(key)}
    else:
        tune_layer(*args.layer, repeats=args.repeats, train=args.train,
                   methods=methods, device=device)
        key = layer_key(*args.layer, backend=backend_of(device))
        entries = {key: lookup(key)}
    print(f"# cache: {cache_path()}")
    print(f"# device: {device}")
    for key, rec in entries.items():
        parts = [f"{d}={e['method']} {e['time_s']:.6f}s ({e['source']})"
                 for d in _DIRECTIONS if (e := rec.get(d))]
        print(f"{key} -> " + "  ".join(parts))


if __name__ == "__main__":
    main()
