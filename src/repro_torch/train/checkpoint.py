"""Step-atomic npz checkpoints with restart support. Mirrors
``repro/train/checkpoint.py``, in the same file layout, so checkpoints
interchange between the two packages.

Layout: ``<dir>/step_<N>.npz``, written to a temp file and published with
``os.replace`` (atomic on POSIX), so a crash mid-save never tears the
latest checkpoint. The tree's nesting is encoded in the keys, joined by
``|``, with the reference's scheme: a dict's key as it is, a list's (or a
tuple's) item ``i`` as ``#i`` and a NamedTuple's field ``f`` as ``@f``
(restored as a dict, as the reference restores it). numpy has no bfloat16, so a bf16 leaf is stored as its ``uint16``
bits under the key's ``::bf16`` tag (the reference does the same through
``ml_dtypes``, which the port does not use).

Restore skips a corrupt, truncated or unreadable ``step_*.npz`` and falls
back to the newest one that loads; ``*.tmp`` residue is never a step and
:func:`gc_checkpoints` sweeps it. Restored leaves are CPU tensors;
:func:`place_like` puts them on the live state's devices and dtypes, and
places them again where the live leaf is placed (a ``DTensor``). A placed
state is saved whole: every rank gathers it
(:func:`repro_torch.distributed.sharding.full_tree`) and global rank 0
writes it, in the same file format.
"""
from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

_SEP = "|"
_BF16_TAG = "::bf16"
# the atomic publish of save_checkpoint goes through this indirection, so a
# chaos test can kill the save between writing the temp file and publishing
# it (repro_torch.train.fault_injection.arm_crash_before_publish)
_REPLACE = os.replace


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    if hasattr(tree, "_fields"):   # a NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}@{k}{_SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
        return out
    key = prefix.rstrip(_SEP)
    if isinstance(tree, torch.Tensor):
        if isinstance(tree, DTensor):
            raise ValueError("a placed leaf is saved whole: gather the tree first "
                             "(repro_torch.distributed.sharding.full_tree) on every rank")
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:   # npz can't store bf16 natively
            out[key + _BF16_TAG] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    else:
        out[key] = np.asarray(tree)
    return out


def _leaf(key: str, val: np.ndarray):
    if key.endswith(_BF16_TAG):
        bits = torch.from_numpy(np.ascontiguousarray(val).view(np.int16))
        return key[: -len(_BF16_TAG)], bits.view(torch.bfloat16)
    return key, torch.from_numpy(np.array(val))


def _rebuild(node):
    """A node whose keys are all ``#i`` as a list, all ``@f`` as a dict of
    the fields."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if keys and all(k.startswith("#") for k in keys):
        return [_rebuild(node[f"#{i}"]) for i in range(len(keys))]
    if keys and all(k.startswith("@") for k in keys):
        return {k[1:]: _rebuild(v) for k, v in node.items()}
    return {k: _rebuild(v) for k, v in node.items()}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        key, leaf = _leaf(key, val)
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _rebuild(tree)


def save_checkpoint(ckpt_dir, step: int, params, opt_state, extra=None) -> str:
    """Write ``{"params", "opt_state"[, "extra"]}`` as ``step_<N>.npz``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {"params": params, "opt_state": opt_state}
    if extra:
        state["extra"] = extra
    flat = _flatten(state)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    _REPLACE(tmp, path)  # atomic publish
    return path


def checkpoint_steps(ckpt_dir) -> list:
    """Every checkpoint step on disk, ascending (no validity check)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1)) for f in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)\.npz", f))
    )


def latest_step(ckpt_dir):
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_tree(path) -> dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    tree["params"], tree["opt_state"]  # no checkpoint without both trees
    return tree


def restore_checkpoint(ckpt_dir, step=None, *, log_fn=None):
    """``(step, params, opt_state, extra)`` from the newest checkpoint that
    loads (or exactly ``step``, which must load); ``(None,) * 4`` when
    none does."""
    if step is not None:
        tree = _load_tree(os.path.join(ckpt_dir, f"step_{step:08d}.npz"))
        return step, tree["params"], tree["opt_state"], tree.get("extra")
    for s in reversed(checkpoint_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{s:08d}.npz")
        try:
            tree = _load_tree(path)
        except Exception as e:  # corrupt/truncated/unreadable: fall back
            if log_fn is not None:
                log_fn(f"[checkpoint] skipping unreadable {path}: "
                       f"{type(e).__name__}: {e}")
            continue
        return s, tree["params"], tree["opt_state"], tree.get("extra")
    return None, None, None, None


def place_like(restored, live):
    """Each restored leaf on its live leaf's device, in its dtype; where
    the live leaf is placed, placed as it (each rank keeps its slice of the
    whole leaf it restored)."""
    if isinstance(live, dict):
        return {k: place_like(restored[k], v) for k, v in live.items()}
    if isinstance(live, list):
        if len(restored) != len(live):
            raise ValueError(f"restored list of {len(restored)} items, live {len(live)}")
        return [place_like(r, v) for r, v in zip(restored, live)]
    if isinstance(live, DTensor):
        return distribute_tensor(restored.to(device=live.device, dtype=live.dtype),
                                 live.device_mesh, live.placements, src_data_rank=None)
    return restored.to(device=live.device, dtype=live.dtype)


def gc_checkpoints(ckpt_dir, keep_last: int = 3) -> None:
    """Keep the newest ``keep_last`` checkpoints; sweep ``*.tmp`` residue."""
    for s in checkpoint_steps(ckpt_dir)[:-keep_last]:
        os.unlink(os.path.join(ckpt_dir, f"step_{s:08d}.npz"))
    for f in os.listdir(ckpt_dir):
        if f.endswith(".tmp"):
            try:
                os.unlink(os.path.join(ckpt_dir, f))
            except OSError:
                pass
