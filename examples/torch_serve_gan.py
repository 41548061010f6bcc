"""GAN serving example of the PyTorch + CUDA port: replay a Poisson request
trace through the bucketed dynamic-batching engine. Mirrors
``examples/serve_gan.py``.

Builds one :class:`~repro_torch.serve.GanEngine`, registers one or more
Table-4 zoo generators against it (reduced width by default so the example
runs in seconds; ``--full`` serves the real Table-4 stacks), warms up every
(model, bucket) executable (one CUDA graph each on the card), then replays
a seeded Poisson arrival process: exponential inter-arrival times at
``--rate`` requests/second, request sizes skewed small, models drawn
uniformly. Prints the serving metrics and, with ``--sequential``, the
speedup over serving the same trace one warmed per-request call at a time.

Run:  PYTHONPATH=src python examples/torch_serve_gan.py [--device cpu]
      PYTHONPATH=src python examples/torch_serve_gan.py --models dcgan,ebgan \\
          --requests 128 --rate 800 --sequential
"""
import argparse
import time

import numpy as np


def poisson_trace(models, cfgs, *, rate, n_requests, seed):
    """(requests, arrival offsets): exponential inter-arrivals at ``rate``
    req/s, sizes drawn small-skewed, models uniform."""
    from repro_torch.serve import GenRequest

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    reqs = []
    for _ in range(n_requests):
        name = models[rng.integers(len(models))]
        n = int(rng.choice([1, 1, 1, 2, 2, 4]))
        z = rng.standard_normal((n, cfgs[name].z_dim)).astype(np.float32)
        reqs.append(GenRequest(name, z))
    return reqs, [float(a) for a in arrivals]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models", default="dcgan",
                    help="comma-separated zoo subset to serve "
                         "(dcgan,artgan,gpgan,ebgan)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=400.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="largest batch bucket (power of two)")
    ap.add_argument("--max-wait", type=float, default=0.01,
                    help="deadline (s) before a partial batch flushes")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="backpressure bound, queued samples")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width Table-4 stacks")
    ap.add_argument("--sequential", action="store_true",
                    help="also time sequential per-request dispatch of the "
                         "same trace and print the speedup")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import gan
    from repro_torch.serve import BucketPolicy, GanEngine
    from repro_torch.serve.batching import pow2_buckets
    from repro_torch.serve.gan_engine import sequential_executables

    dev = resolve_device(args.device)
    names = [n.strip() for n in args.models.split(",") if n.strip()]
    for n in names:
        if n not in gan.GAN_ZOO:
            raise SystemExit(f"unknown model {n!r}; zoo: {sorted(gan.GAN_ZOO)}")
    cfgs = {n: (gan.GAN_ZOO[n] if args.full
                else gan.reduced_config(gan.GAN_ZOO[n], scale=32))
            for n in names}

    policy = BucketPolicy(buckets=pow2_buckets(args.max_batch),
                          max_wait_s=args.max_wait, max_queue=args.max_queue)
    engine = GanEngine(policy, device=dev)
    params = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        params[name] = gan.generator_init(torch.Generator().manual_seed(i), cfg,
                                          device=dev)
        engine.register(cfg, params[name], name=name)

    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve_gan] warmed {len(names)} model(s) x {len(policy.buckets)} "
          f"buckets ({engine.warmup_recompiles} executables) on {dev} in "
          f"{time.perf_counter() - t0:.2f}s; max_wait={policy.max_wait_s * 1e3:.0f}ms "
          f"max_queue={policy.max_queue}")

    reqs, arrivals = poisson_trace(names, cfgs, rate=args.rate,
                                   n_requests=args.requests, seed=args.seed)
    n_samples = sum(r.n for r in reqs)
    print(f"[serve_gan] replaying {len(reqs)} requests / {n_samples} samples "
          f"at ~{args.rate:.0f} req/s (trace spans {arrivals[-1]:.2f}s)")

    engine.replay(reqs, arrivals)
    if not all(r.done for r in reqs):
        raise SystemExit("[serve_gan] a request was not served")
    print(f"[serve_gan] {engine.metrics.describe()}")
    if engine.metrics.recompiles != engine.warmup_recompiles:
        print("[serve_gan] WARNING: steady-state recompiles detected "
              f"({engine.metrics.recompiles - engine.warmup_recompiles})")

    if args.sequential:
        fns = {}
        for name, cfg in cfgs.items():
            sizes = sorted({r.n for r in reqs if r.model == name})
            for n, fn in sequential_executables(cfg, params[name], sizes,
                                                device=dev).items():
                fns[name, n] = fn
        t0 = time.perf_counter()
        for r in reqs:
            fns[r.model, r.n](params[r.model], torch.as_tensor(r.z)).cpu()
        seq_s = time.perf_counter() - t0
        busy = engine.metrics.batch_wall_s
        print(f"[serve_gan] sequential per-request dispatch: {seq_s:.3f}s "
              f"vs engine execute time {busy:.3f}s (x{seq_s / busy:.2f} on "
              f"compute; arrival-paced wall {engine.metrics.elapsed_s:.3f}s)")
    return reqs


if __name__ == "__main__":
    main()
