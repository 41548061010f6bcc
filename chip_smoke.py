#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  -- the card's name, count and power limit; TF32 off for matmul
              and cuDNN, so every fp32 comparison is fp32.
2. build   -- both CUDA kernels compiled from src/repro_torch/kernels/csrc
              (in parallel), with nvcc's -Xptxas -v report.
3. check   -- each kernel against its plain PyTorch version at the four
              DCGAN layer shapes at batch 8 and at odd geometries, with
              every epilogue, within 1e-4 * max|ref| + 1e-5.
4. times   -- per DCGAN layer at batch 8, by CUDA events after warm-up:
              kernel, plain version, one-call library yardstick
              (F.conv_transpose2d + activation, which the port never calls)
              and the roofline bound; then the whole generator per bucket
              through the kernels and through two PyTorch baselines, and
              a torch.profiler pass giving the device's busy time and idle
              share per generator call.
5. engine  -- GanEngine serving full-width DCGAN (random weights from a
              seed, buckets 1/2/4/8): warm-up, a replayed trace of 32
              requests of 1-4 samples, then the serving checks (every
              request done, conservation, no builds after warm-up, finite
              outputs, both kernels launched, each request bitwise equal to
              its own unbatched call, agreement with a unified_reshape plan);
              then whether one batched projection matmul gives each row the
              bits of its one-row call, at every row count from 1 to 8.
6. serving -- throughput and latency over open-loop Poisson traces of
              SERVE_WINDOW_S seconds at each of SERVE_RATES requests/s
              (same request mix), each on a freshly warmed engine. The
              32-request replay of phase 5 is a check, too short to rate.
7. result  -- a JSON line of per-kernel numbers, then the last line
              {"ok": true, "device": {...}}.

Full results also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BPS = 3.35e12    # H100 SXM HBM3
BATCH = 8
TOL_REL, TOL_ABS = 1e-4, 1e-5   # fp32 sums of up to 16384 terms, reordered
DCGAN_SHAPES = [  # (B, N, n, P, Cin, Cout) of DCGAN L0..L3 at batch 8
    (BATCH, 4, 4, 2, 1024, 512), (BATCH, 8, 4, 2, 512, 256),
    (BATCH, 16, 4, 2, 256, 128), (BATCH, 32, 4, 2, 128, 3),
]
ODD_SHAPES = [
    (2, 7, 3, 0, 37, 19),    # n = 3, P = 0: odd M = 11; Cout not a tile multiple
    (2, 6, 5, 1, 20, 70),    # n = 5, odd P: M = 9
    (1, 9, 3, 3, 33, 5),     # n = 3, odd P: M = 21
    (2, 5, 5, 3, 9, 130),    # n = 5, P = 3: M = 11, Cout = 130
]
SERVE_RATES = (250.0, 1000.0, 2000.0)   # offered requests/s, open loop
SERVE_WINDOW_S = 5.0
SOURCES = {
    "fused": ("src/repro_torch/kernels/csrc/transpose_conv2d_fused.cu",
              "src/repro/kernels/transpose_conv2d.py:257"),
    "gemm": ("src/repro_torch/kernels/csrc/transpose_conv2d_gemm.cu",
             "src/repro/kernels/transpose_conv2d_gemm.py:234"),
}


def log(*args) -> None:
    print(*args, flush=True)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log(f"[device] {info['name']} x{info['count']}  torch {info['torch']} "
        f"cuda {info['cuda']}")
    log(smi)
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return info


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build("transpose_conv2d_fused", "transpose_conv2d_gemm")
    log(f"[build] both kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():   # registers, shared memory, spills
        for line in text.splitlines():
            if line.strip():
                log(f"[build] {name}: {line.strip()}")
    return logs


def _inputs(torch, shape, seed):
    b, n_in, n_k, _, cin, cout = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n_in, n_in, cin), device="cuda", generator=g)
    k = torch.randn((n_k, n_k, cin, cout), device="cuda", generator=g)
    k *= (n_k * n_k * cin) ** -0.5
    bias = 0.1 * torch.randn((cout,), device="cuda", generator=g)
    return x, k, bias


def kernels():
    from repro_torch.kernels import transpose_conv2d as tcf
    from repro_torch.kernels import transpose_conv2d_gemm as tcg

    return {
        "fused": (tcf.transpose_conv2d_fused, tcf.transpose_conv2d_fused_plain),
        "gemm": (tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain),
    }


def phase_check(torch) -> dict:
    from repro_torch.kernels.epilogue import Epilogue

    epis = [None, Epilogue(True), Epilogue(True, "relu"), Epilogue(True, "tanh"),
            Epilogue(True, "leaky_relu", 0.2)]
    worst = {}
    for name, (launch, plain) in kernels().items():
        worst[name] = 0.0
        for i, shape in enumerate(DCGAN_SHAPES + ODD_SHAPES):
            x, k, bias = _inputs(torch, shape, seed=i)
            pad = shape[3]
            for epi in epis:
                b = bias if epi is not None else None
                got = launch(x, k, pad, epilogue=epi, bias=b)
                want = plain(x, k, pad, epilogue=epi, bias=b)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                tol = TOL_REL * scale + TOL_ABS
                tag = epi.tag() if epi else "none"
                log(f"[check] {name} {shape} {tag}: max abs err {err:.3e} "
                    f"rel {err / max(scale, 1e-30):.3e} (tol {tol:.3e})")
                if not (got.shape == want.shape and err <= tol):
                    raise AssertionError(
                        f"{name} kernel disagrees with its plain version at "
                        f"{shape} {tag}: {err} > {tol}")
                worst[name] = max(worst[name], err)
    return worst


def _bound(shape) -> dict:
    from repro_torch.core.segregation import flop_count, output_size

    b, n_in, n_k, pad, cin, cout = shape
    m = output_size(n_in, n_k, pad)
    flops = 2 * b * flop_count(n_in, n_k, cin, cout, pad)
    nbytes = 4 * (b * n_in * n_in * cin + n_k * n_k * cin * cout + cout
                  + b * m * m * cout)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BPS * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_times(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.plan import cold_method
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    layers = []
    for i, shape in enumerate(DCGAN_SHAPES):
        b, n_in, n_k, pad, cin, cout = shape
        x, k, bias = _inputs(torch, shape, seed=100 + i)
        epi = Epilogue(True, "tanh" if i == len(DCGAN_SHAPES) - 1 else "relu")
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        act = torch.tanh if epi.act == "tanh" else torch.relu

        def library(xx, ww, bb, _pad=n_k - 1 - pad, _act=act):
            return _act(F.conv_transpose2d(xx, ww, bb, stride=2, padding=_pad))

        row = {"layer": f"L{i}", "shape": shape, "path": cold_method(n_in, n_k, pad),
               **_bound(shape),
               "library_ms": time_cuda(library, x_nchw, w_t, bias)}
        for name, (launch, plain) in kernels().items():
            row[f"{name}_ms"] = time_cuda(launch, x, k, pad, epilogue=epi, bias=bias)
            row[f"{name}_plain_ms"] = time_cuda(plain, x, k, pad, epilogue=epi,
                                                bias=bias, iters=5)
        layers.append(row)
        log(f"[times] L{i} {shape} path={row['path']}: fused {row['fused_ms']:.4f} ms"
            f" gemm {row['gemm_ms']:.4f} ms | plain fused "
            f"{row['fused_plain_ms']:.4f} gemm {row['gemm_plain_ms']:.4f} | "
            f"library {row['library_ms']:.4f} | bound {row['bound_ms'] * 1e3:.2f} us"
            f" ({row['bound_by']})")

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    generator = []
    for bucket in (1, 2, 4, 8):
        z = torch.randn((bucket, cfg.z_dim), device="cuda")
        row = {"bucket": bucket}
        for method in ("auto", "unified_reshape", "xla"):
            plan = gan.generator_plan(cfg, bucket, method=method)
            row[method] = time_cuda(gan.generator_apply, params, cfg, z, plan=plan)
        generator.append(row)
        log(f"[times] generator b{bucket}: kernels {row['auto']:.4f} ms, "
            f"unified_reshape {row['unified_reshape']:.4f} ms, xla {row['xla']:.4f} ms")
    return {"layers": layers, "generator": generator}


def phase_profile(torch) -> dict:
    """Device busy time of the generator through the kernels, from
    torch.profiler over 10 calls at batch 1 and 8: per-call device time,
    the share of the (profiled) wall the device sat idle, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    out = {}
    for bucket in (1, BATCH):
        z = torch.randn((bucket, cfg.z_dim), device="cuda")
        plan = gan.generator_plan(cfg, bucket)
        gan.generator_apply(params, cfg, z, plan=plan)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                gan.generator_apply(params, cfg, z, plan=plan)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = {e.key: e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
        busy = sum(dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        out[bucket] = {
            "wall_us_per_call": wall_us / 10, "device_us_per_call": busy / 10,
            "idle_share": 1 - busy / wall_us,
            "top": [[name[:90], us / 10] for name, us in top],
        }
        log(f"[profile] b{bucket}: device {busy / 10:.1f} us per call of "
            f"{wall_us / 10:.1f} us profiled wall, idle share "
            f"{1 - busy / wall_us:.3f}")
        for name, us in out[bucket]["top"]:
            log(f"[profile]   {us:9.1f} us  {name}")
    return out


def phase_engine(torch) -> dict:
    import numpy as np

    from repro_torch.models import gan
    from repro_torch.serve import BucketPolicy, GanEngine, GenRequest

    launchers = {name: fns[0] for name, fns in kernels().items()}
    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    eng = GanEngine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.002,
                                 max_queue=256))
    eng.register(cfg, params)
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 5, size=32)
    reqs = [GenRequest("dcgan", rng.standard_normal((int(n), cfg.z_dim))
                       .astype(np.float32)) for n in sizes]
    arrivals = np.cumsum(rng.exponential(1e-3, size=len(reqs))).tolist()

    for fn in launchers.values():
        fn.launches = 0
    eng.replay(reqs, arrivals)
    launches = {name: fn.launches for name, fn in launchers.items()}

    summary = eng.metrics.summary()
    cons = eng.conservation()
    if not all(r.done for r in reqs):
        raise AssertionError("not every request was served")
    if not cons["ok"]:
        raise AssertionError(f"conservation failed: {cons}")
    if eng.metrics.recompiles != eng.warmup_recompiles:
        raise AssertionError("executables were built after warm-up")
    if not all(bool(torch.isfinite(r.output).all()) for r in reqs):
        raise AssertionError("non-finite output")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for r in reqs:
        one = gan.generator_apply(params, cfg, r.z).cpu()
        if not torch.equal(one, r.output):
            raise AssertionError(
                f"request {r.rid} (n={r.n}) differs from its unbatched call "
                f"by {(one - r.output).abs().max().item()}")
    z = torch.randn((BATCH, cfg.z_dim), device="cuda")
    got = gan.generator_apply(params, cfg, z, plan=gan.generator_plan(cfg, BATCH))
    want = gan.generator_apply(params, cfg, z, plan=gan.generator_plan(
        cfg, BATCH, method="unified_reshape"))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL_REL * want.abs().max().item() + TOL_ABS
    if err > tol:
        raise AssertionError(f"kernels vs unified_reshape plan: {err} > {tol}")
    lat = summary["latency_s"]
    log(f"[engine] {torch.cuda.get_device_name(0)}: {summary['requests']} requests"
        f" / {summary['samples']} samples in {summary['batches']} batches, "
        f"{summary['samples_per_s']:.1f} samples/s, latency p50 "
        f"{lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms, pad waste "
        f"{summary['pad_waste']:.3f}, warm-up {warm_s:.2f} s")
    log(f"[engine] launches during serving {launches}; bitwise batch-invariant; "
        f"vs unified_reshape max abs err {err:.3e}; conservation {cons}")
    return {"summary": {k: v for k, v in summary.items() if k != "per_model"},
            "launches": launches, "warmup_s": warm_s, "vs_unified_reshape": err}


def phase_projection(torch) -> dict:
    """Whether one batched ``z @ w`` at the DCGAN projection's shape gives
    each row the same bits as that row's own one-row call, for every row
    count a bucket or a request can have (1-8)."""
    from repro_torch.models import gan

    cfg = gan.DCGAN
    h0, c0, _ = cfg.layers[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    w = 0.02 * torch.randn((cfg.z_dim, h0 * h0 * c0), device="cuda", generator=g)
    z = torch.randn((8, cfg.z_dim), device="cuda", generator=g)
    rows = torch.cat([z[i : i + 1] @ w for i in range(8)])
    out = {}
    for m in range(1, 9):
        batched = z[:m] @ w
        out[m] = {"bitwise": bool(torch.equal(batched, rows[:m])),
                  "max_abs_diff": (batched - rows[:m]).abs().max().item()}
        log(f"[projection] batched z[:{m}] @ w vs one-row calls: bitwise "
            f"{out[m]['bitwise']}, max abs diff {out[m]['max_abs_diff']:.3e}")
    return out


def phase_serving(torch) -> list:
    import numpy as np

    from repro_torch.models import gan
    from repro_torch.serve import BucketPolicy, GanEngine, GenRequest

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    rows = []
    for rate in SERVE_RATES:
        eng = GanEngine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.002,
                                     max_queue=256))
        eng.register(cfg, params)
        eng.warmup()
        rng = np.random.default_rng(int(rate))
        count = int(rate * SERVE_WINDOW_S)
        sizes = rng.integers(1, 5, size=count)
        zs = rng.standard_normal((int(sizes.sum()), cfg.z_dim)).astype(np.float32)
        ends = np.cumsum(sizes)
        reqs = [GenRequest("dcgan", zs[e - n : e]) for n, e in zip(sizes, ends)]
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=count)).tolist()
        t0 = time.perf_counter()
        eng.replay(reqs, arrivals)
        wall_s = time.perf_counter() - t0
        cons = eng.conservation()
        if not cons["ok"] or cons["failed"] or cons["expired"]:
            raise AssertionError(f"serving at {rate} req/s: {cons}")
        if eng.metrics.recompiles != eng.warmup_recompiles:
            raise AssertionError("executables were built after warm-up")
        s = eng.metrics.summary()
        lat = s["latency_s"]
        row = {"offered_requests_per_s": rate,
               "offered_samples_per_s": rate * float(sizes.mean()),
               "window_s": SERVE_WINDOW_S, "wall_s": wall_s,
               "requests": count, "done": s["requests"], "rejected": s["rejected"],
               "samples": s["samples"], "batches": s["batches"],
               "samples_per_s": s["samples_per_s"],
               "requests_per_s": s["requests_per_s"], "pad_waste": s["pad_waste"],
               "latency_ms": {k: v * 1e3 for k, v in lat.items()}}
        rows.append(row)
        log(f"[serve] {torch.cuda.get_device_name(0)} offered {rate} req/s "
            f"({row['offered_samples_per_s']} samples/s) for {SERVE_WINDOW_S} s:"
            f" {s['requests']} done, {s['rejected']} rejected, {s['samples']} "
            f"samples in {s['batches']} batches, {s['samples_per_s']} samples/s,"
            f" latency ms p50 {lat['p50'] * 1e3} p95 {lat['p95'] * 1e3} p99 "
            f"{lat['p99'] * 1e3} max {lat['max'] * 1e3}, pad waste "
            f"{s['pad_waste']}, replay wall {wall_s} s")
        del eng, reqs
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build()
    worst = phase_check(torch)
    times = phase_times(torch)
    profiled = phase_profile(torch)
    engine = phase_engine(torch)
    projection = phase_projection(torch)
    serving = phase_serving(torch)

    entries = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in times["layers"] if r["path"] == name]
        ops = sum(r["ops_ms"] for r in rows)
        byt = sum(r["bytes_ms"] for r in rows)
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": engine["launches"][name],
            "max_abs_err": worst[name],
            "ms": sum(r[f"{name}_ms"] for r in rows),
            "plain_ms": sum(r[f"{name}_plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if ops >= byt else "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "kernels": entries, "times": times,
                   "profile": profiled, "engine": engine, "projection": projection,
                   "serving": serving, "max_abs_err": worst,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
