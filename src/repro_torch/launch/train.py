"""Training entry point. Mirrors ``repro/launch/train.py``.

Runs a registered arch (full or ``--reduced``) through the fault-tolerant
:class:`~repro_torch.train.trainer.Trainer`: deterministic data,
step-atomic checkpoints, auto-resume, on the CUDA card unless ``--device``
names another:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

The run is under a mesh (:func:`~repro_torch.distributed.sharding.use_mesh`).
``--mesh host`` (the default) is the 1x1 ``(data, model)`` mesh over a
one-rank process group (NCCL on the card, gloo on the CPU;
:func:`~repro_torch.launch.mesh.make_host_mesh`). ``single-pod`` and
``multi-pod`` are the production meshes, which need a ``torchrun`` world
of 256 or 512 ranks (:func:`~repro_torch.launch.mesh.make_production_mesh`
raises ``ValueError`` under any other), each rank on the card of its
``LOCAL_RANK``. Every rank builds the same global batch, a pure function
of ``(seed, step)``, and the state is placed over the mesh
(``init_train_state(..., mesh=)``): Megatron TP over ``model`` and ZeRO-3
over ``data`` as the config's ``train_parallelism`` and ``fsdp`` say, with
the reference's fall-back from ``fsdp`` to ``tp`` when the batch does not
divide the ranks (:func:`~repro_torch.distributed.sharding.
parallelism_for`). Every rank gathers the state for a checkpoint and
global rank 0 writes it.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.configs.registry import ARCH_IDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default="host", choices=["host", "single-pod", "multi-pod"])
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)
    # the step runs under deterministic algorithms (Trainer): cuBLAS needs a
    # fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    import torch.distributed as dist

    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import get_parallelism, set_parallelism, use_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    owned = not dist.is_initialized()   # a group made here is destroyed here
    mode = get_parallelism()   # placing sets the mode; restored on the way out
    try:
        if args.mesh == "host":
            device = resolve_device(args.device)
            mesh = make_host_mesh(device)
        else:
            mesh = make_production_mesh(multi_pod=args.mesh == "multi-pod")
            device = resolve_device(args.device)
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
        model = build_model(cfg)
        train_cfg = TrainConfig(
            optimizer=AdamWConfig(lr=args.lr),
            warmup_steps=max(args.steps // 20, 1),
            total_steps=args.steps,
            compress_grads=args.compress_grads,
        )
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, device=device)
        with use_mesh(mesh):
            params, opt_state = init_train_state(
                model, torch.Generator(device=device).manual_seed(0), train_cfg,
                device=device, mesh=mesh, global_batch=args.batch)
            trainer = Trainer(model, make_train_step(model, train_cfg), data,
                              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
            params, opt_state, history = trainer.run(params, opt_state,
                                                     steps=args.steps)
        if history:
            print(f"[train] {args.arch}: loss {history[0]:.4f} -> {history[-1]:.4f} "
                  f"over {len(history)} steps (skipped {trainer.skipped_steps}), "
                  f"median step {trainer.timer.median() * 1e3:.1f} ms on {device}, "
                  f"mesh {args.mesh} {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
                  f"{dist.get_world_size()} {dist.get_backend()} rank(s), placed in "
                  f"{get_parallelism()} mode")
        return history
    finally:
        set_parallelism(mode)
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
