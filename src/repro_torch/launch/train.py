"""Training entry point. Mirrors ``repro/launch/train.py``.

Runs a registered arch (full or ``--reduced``) through the fault-tolerant
:class:`~repro_torch.train.trainer.Trainer`: deterministic data,
step-atomic checkpoints, auto-resume, on the CUDA card unless ``--device``
names another:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

``--mesh`` keeps only ``host`` (one device); the reference's ``single-pod``
and ``multi-pod`` meshes wait for the distribution item (ROADMAP queue 1,
"Distribution") and raise ``NotImplementedError``.
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
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port runs on one device; multi-device meshes "
            'wait for ROADMAP queue 1, "Distribution"')
    # the step runs under deterministic algorithms (Trainer): cuBLAS needs a
    # fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

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
    params, opt_state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), train_cfg, device=device)
    trainer = Trainer(model, make_train_step(model, train_cfg), data,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    params, opt_state, history = trainer.run(params, opt_state, steps=args.steps)
    if history:
        print(f"[train] {args.arch}: loss {history[0]:.4f} -> {history[-1]:.4f} "
              f"over {len(history)} steps (skipped {trainer.skipped_steps}), "
              f"median step {trainer.timer.median() * 1e3:.1f} ms on {device}")
    return history


if __name__ == "__main__":
    main()
