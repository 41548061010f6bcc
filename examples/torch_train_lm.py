"""End-to-end training example of the PyTorch + CUDA port: a reduced-width
xLSTM through the fault-tolerant LM Trainer, with deterministic data,
step-atomic checkpoints (re-run to resume), a cosine schedule and optional
int8 gradient compression. Mirrors ``examples/train_lm.py``.

On the card each step is one CUDA graph under deterministic algorithms;
on the CPU it runs eagerly.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # the Trainer runs the step under deterministic algorithms: cuBLAS
    # needs a fixed workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    # xlstm-125m at reduced width (d_model 768 -> 256), the same family and
    # period structure as the full config
    cfg = dataclasses.replace(
        get_config("xlstm-125m"),
        d_model=256, n_layers=4, n_heads=4, vocab_size=8_192,
        remat=False, attn_chunk=64,
    )
    model = build_model(cfg)
    print(f"[train_lm] {cfg.name}-reduced: {cfg.param_count() / 1e6:.1f}M params on {dev}")

    tc = TrainConfig(
        optimizer=AdamWConfig(lr=1e-3),
        warmup_steps=20,
        total_steps=args.steps,
        compress_grads=args.compress_grads,
    )
    params, opt = init_train_state(model, torch.Generator(device=dev).manual_seed(0), tc,
                                   device=dev)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, device=dev)
    trainer = Trainer(model, make_train_step(model, tc), data,
                      ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20)
    params, opt, history = trainer.run(params, opt, steps=args.steps)
    if history:
        print(f"[train_lm] loss {history[0]:.4f} -> {history[-1]:.4f}; "
              f"checkpoints in {args.ckpt_dir} (re-run to resume)")
    return history


if __name__ == "__main__":
    main()
