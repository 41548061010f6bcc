"""Quickstart of the PyTorch + CUDA port: the unified kernel-segregated
transpose convolution. Mirrors ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) ``method="pallas"`` launches the hand-written
phase-fused kernel; on the CPU it runs that kernel's plain PyTorch version.
"""
import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.core import (
        flop_count,
        memory_savings_bytes,
        segregate_kernel,
        transpose_conv2d,
    )
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    # a 224x224 RGB feature map and a 5x5 kernel, paper-style
    x = torch.randn((1, 224, 224, 3), generator=gen, device=dev)
    k = torch.randn((5, 5, 3, 8), generator=gen, device=dev) * 0.1

    # 1. the paper's baseline: bed-of-nails upsample + dense conv (Algorithm 1)
    y_conv = transpose_conv2d(x, k, padding=2, method="conventional")
    # 2. the paper's contribution: unified kernel segregation (Algorithm 2)
    y_uni = transpose_conv2d(x, k, padding=2, method="unified")
    # 3. the hand-written phase-fused kernel (one launch, all four phases)
    y_ker = transpose_conv2d(x, k, padding=2, method="pallas")

    print("output shape:", tuple(y_uni.shape), "on", dev)
    print("max |unified - conventional|:", float((y_uni - y_conv).abs().max()))
    print("max |kernel  - conventional|:", float((y_ker - y_conv).abs().max()))

    # the four sub-kernels (paper Fig. 4)
    subs = segregate_kernel(k)
    print("sub-kernel shapes:", [tuple(s.shape[:2]) for s in subs])

    # the arithmetic the segregation saves
    conv = flop_count(224, 5, 3, 8, 2, method="conventional")
    segd = flop_count(224, 5, 3, 8, 2, method="segregated")
    print(f"MACs: conventional {conv:,} vs segregated {segd:,} "
          f"({conv / segd:.2f}x fewer)")
    print(f"memory savings: {memory_savings_bytes(224, 3, 4, 2) / 1e6:.4f} MB "
          f"(paper Table 2: 1.8279 MB)")

    # it's differentiable end to end (any method)
    kk = k.clone().requires_grad_(True)
    (transpose_conv2d(x, kk, 2, method="unified") ** 2).sum().backward()
    print("grad ok:", tuple(kk.grad.shape), bool(torch.isfinite(kk.grad).all()))
    return y_ker


if __name__ == "__main__":
    main()
