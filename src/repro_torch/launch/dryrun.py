"""Production-mesh dry run. Mirrors ``repro/launch/dryrun.py``.

The proof that the distribution config is coherent without the hardware:
each (arch x input shape) cell builds its state as meta tensors (shapes
and dtypes, no storage; DTensor runs its own ``FakeTensorMode`` where it
infers an op's output metadata), places it on the
production mesh's shape over a ``fake`` process group of 256 or 512 ranks
in this one process (:func:`repro_torch.launch.mesh.fake_production_mesh`),
and traces one train, prefill or decode step placed, as every rank would
run it. A placement that does not fit, a sharding DTensor cannot
propagate, or a collective it cannot issue fails the cell. The step is
watched op by op (:class:`repro_torch.launch.op_analysis.OpCounter`):
per-rank FLOPs, bytes and collective wire bytes, and the per-rank bytes of
its arguments, outputs and the peak of the storages it allocates. They are
arithmetic over the traced shapes, not measurements. The report has the
reference's keys and its three-term roofline
(:func:`repro_torch.launch.roofline.roofline_report`, the H100's peaks).

The state's specs are the reference's: the parameters by
:func:`~repro_torch.distributed.sharding.param_specs`, the moments by
:func:`opt_specs_from`, the caches by :func:`cache_specs` and the batch by
:func:`batch_shardings` (this module re-exports the port's copies). The
step runs in the mode the reference's dry run picks
(:func:`~repro_torch.distributed.sharding.parallelism_for`). Every family
is placed; a cell that :func:`~repro_torch.configs.runnable` refuses
(``long_500k`` of a full-attention arch) is reported skipped, with the
reason.

Usage (no card needed; the output directory is listed in ``.gitignore``)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, get_config, input_specs, runnable
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (  # noqa: F401  (the reference's names)
    batch_shardings,
    cache_specs,
    opt_specs_from,
    shard_shape,
)
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.launch.roofline import roofline_report
from repro_torch.models.lm import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.train_step import (
    TrainConfig,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

DEFAULT_OUT = "build/dryrun"


def moment_dtype(arch: str, cfg) -> str:
    """The reference's dry-run optimizer: int8 moments for Kimi-K2, bf16
    under ``fsdp``, fp32 otherwise."""
    if arch.startswith("kimi"):
        return "int8"
    return "bfloat16" if cfg.fsdp else "float32"


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every leaf of ``tree`` (``None``: 0)."""
    if tree is None:
        return 0
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in sharding.state_leaves(tree) if isinstance(t, torch.Tensor))


def _meta_batch(cfg, shape) -> dict:
    """The cell's inputs as meta tensors, whole on every rank (call under
    ``torch.device("meta")``)."""
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in input_specs(cfg, shape).items()}


def _batch_bytes(batch, mesh) -> int:
    """Per-rank bytes of the batch as :func:`batch_shardings` splits it."""
    specs = batch_shardings(mesh, batch)
    return sum(
        torch.Size(shard_shape(tuple(v.shape), specs[k], mesh)).numel() * v.element_size()
        for k, v in batch.items())


def placed_state(cfg, shape, mesh, arch: str):
    """The cell's state as meta tensors placed on ``mesh`` (call under
    ``torch.device("meta")``): ``(mode, params, opt_state or None, cache or
    None, train_cfg)``; the mode is set as the current one."""
    model = build_model(cfg)
    mode = sharding.parallelism_for(cfg, shape.kind, shape.global_batch, mesh)
    sharding.set_parallelism(mode)
    train_cfg = TrainConfig(optimizer=AdamWConfig(moment_dtype=moment_dtype(arch, cfg)))
    params = model.abstract_params()
    params = sharding.distribute_params(params, mesh, cfg.fsdp)
    opt = adamw_init(params, train_cfg.optimizer) if shape.kind == "train" else None
    cache = None
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta", mesh=mesh)
    return mode, params, opt, cache, train_cfg


def trace_cell(cfg, shape, mesh, arch: str):
    """Place one cell's state on ``mesh`` and trace its step: ``(counter,
    meta)``, the :class:`~repro_torch.launch.op_analysis.OpCounter` and
    ``{"mode", "argument", "output", "state", "trace_s"}`` (``state``: the
    parameter, optimizer and cache bytes a rank)."""
    model = build_model(cfg)
    prev = sharding.get_parallelism()
    t0 = time.time()
    try:
        with torch.device("meta"), sharding.use_mesh(mesh, placed=True):
            mode, params, opt, cache, train_cfg = placed_state(cfg, shape, mesh, arch)
            batch = _meta_batch(cfg, shape)
            state = {"parameter": _local_bytes(params), "optimizer": _local_bytes(opt),
                     "cache": _local_bytes(cache)}
            argument = sum(state.values()) + _batch_bytes(batch, mesh)
            with OpCounter() as counter:
                if shape.kind == "train":
                    out = make_train_step(model, train_cfg)(params, opt, batch)
                elif shape.kind == "prefill":
                    out = make_prefill_step(model)(params, batch)
                else:
                    out = make_serve_step(model)(params, cache, batch)
                output = _local_bytes(out)
                del out
    finally:
        sharding.set_parallelism(prev)
    return counter, {"mode": mode, "argument": argument, "output": output,
                     "state": state, "trace_s": round(time.time() - t0, 1)}


def _resolve(arch, shape_name, cfg, shape):
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    return cfg, shape


def compile_cell(arch: str, shape_name: str, *, multi_pod: bool = False, cfg=None,
                 shape=None):
    """Trace one cell (the reference's lower + compile): ``(counter,
    meta)``, for profiling (:mod:`repro_torch.launch.attribution`)."""
    cfg, shape = _resolve(arch, shape_name, cfg, shape)
    with fake_production_mesh(multi_pod=multi_pod) as mesh:
        counter, meta = trace_cell(cfg, shape, mesh, arch)
        meta["mesh"] = "x".join(map(str, mesh.shape))
        meta["chips"] = mesh.size()
    return counter, {"cfg": cfg, "shape": shape, **meta}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose=True,
                extra_flags=None, cfg=None, shape=None) -> dict:
    """Place and trace one (arch x shape x mesh) cell; return the report.
    ``cfg=`` and ``shape=`` (a ``ShapeSpec``) replace the registry's (a
    reduced config, a smaller shape)."""
    cfg, shape = _resolve(arch, shape_name, cfg, shape)
    if extra_flags:
        cfg = dataclasses.replace(cfg, **extra_flags)
    ok, reason = runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": reason}
    counter, meta = compile_cell(arch, shape.name, multi_pod=multi_pod, cfg=cfg, shape=shape)
    walk = counter.report()
    report = {
        "arch": arch,
        "shape": shape.name,
        "mesh": meta["mesh"],
        "chips": meta["chips"],
        "mode": meta["mode"],
        "trace_s": meta["trace_s"],
        "flops": walk["flops"],
        "bytes_accessed": walk["bytes"],
        "collectives": walk["collectives"],
        "memory": {
            "argument_size_in_bytes": meta["argument"],
            "output_size_in_bytes": meta["output"],
            "temp_size_in_bytes": counter.peak_bytes,
            # the argument bytes' parts: this rank's shards of the state
            **{f"{k}_size_in_bytes": v for k, v in meta["state"].items()},
        },
    }
    report["roofline"] = roofline_report(report, cfg, shape)
    if verbose:
        print(json.dumps(report, indent=1, default=str))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    arches = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures, t_all = [], time.time()
    for arch in arches:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'512' if mp else '256'}"
                path = os.path.join(args.out, tag + ".json")
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rep = dryrun_cell(arch, shape, multi_pod=mp, verbose=len(arches) == 1
                                      and len(shapes) == 1 and len(meshes) == 1)
                    with open(path, "w") as f:
                        json.dump(rep, f, indent=1, default=str)
                    keys = ("skipped", "mode", "flops", "trace_s")
                    print(f"[done] {tag}: " + str({k: rep.get(k) for k in keys if k in rep}),
                          flush=True)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((tag, f"{type(e).__name__}: {e}"))
    print(f"[dryrun] wall {time.time() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
