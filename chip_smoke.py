#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  -- the card's name, count and power limit; TF32 off for matmul
              and cuDNN, so every fp32 comparison is fp32; cudnn.benchmark
              off; CUBLAS_WORKSPACE_CONFIG set before torch is imported.
2. build   -- the three CUDA sources compiled from src/repro_torch/kernels/csrc
              (in parallel), with nvcc's -Xptxas -v report.
3. check   -- each forward kernel against its plain PyTorch version at the
              four DCGAN layer shapes at batch 8 and at odd geometries, with
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
7. bwd     -- each backward kernel (epilogue-grad, dx, dw with db) against
              its plain version at the same shapes and epilogues, same
              tolerance.
8. autograd -- the full-width DCGAN generator's parameter gradients of a
              scalar loss through the backward kernels against those of the
              plan pinned to bwd="autograd" (cuDNN), same tolerance.
9. bwd times -- per DCGAN layer at batch 8: each backward kernel, its plain
              version, a one-call library yardstick and the bound.
10. train  -- deterministic algorithms on (a bit-exact resume needs them;
              phases 3-9 run and are timed without them), then GanTrainer on
              full-width DCGAN (GanTrainerConfig defaults, global batch 8):
              6 steps checkpointing every 3 with every kernel launched; a
              resume from step 3 bitwise equal to the uninterrupted run
              (losses, params, moments); a NaN step that leaves the state
              bitwise untouched; the time a step's inputs take to draw;
              TRAIN_WINDOWS alternating windows of 30 timed steps through
              the kernels and with the plan pinned to bwd="autograd"; one
              profiled step.
11. result -- a JSON line of per-kernel numbers, then the last line
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
TRAIN_TIMED_STEPS, TRAIN_WARMUP_STEPS, TRAIN_WINDOWS = 30, 5, 3
BWD_CU = "src/repro_torch/kernels/csrc/transpose_conv2d_bwd.cu"
SOURCES = {
    "fused": ("src/repro_torch/kernels/csrc/transpose_conv2d_fused.cu",
              "src/repro/kernels/transpose_conv2d.py:257"),
    "gemm": ("src/repro_torch/kernels/csrc/transpose_conv2d_gemm.cu",
             "src/repro/kernels/transpose_conv2d_gemm.py:234"),
    "epilogue_grad": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:194"),
    "dx": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:306"),
    "dw": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:485"),
}
FORWARD = ("fused", "gemm")


def log(*args) -> None:
    print(*args, flush=True)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
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
    _log_determinism(torch, "device")
    return info


def _log_determinism(torch, tag) -> None:
    log(f"[{tag}] deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}, cudnn.benchmark="
        f"{torch.backends.cudnn.benchmark}, fill_uninitialized_memory="
        f"{torch.utils.deterministic.fill_uninitialized_memory}")


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build("transpose_conv2d_fused", "transpose_conv2d_gemm",
                        "transpose_conv2d_bwd")
    log(f"[build] three sources in {time.perf_counter() - t0:.1f} s")
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


def kernels(names=tuple(SOURCES)):
    """``{name: (wrapper, plain version)}`` of the kernels ``names``."""
    from repro_torch.kernels import transpose_conv2d as tcf
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels import transpose_conv2d_gemm as tcg

    every = {
        "fused": (tcf.transpose_conv2d_fused, tcf.transpose_conv2d_fused_plain),
        "gemm": (tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain),
        "epilogue_grad": (bw.epilogue_grad, bw.epilogue_grad_plain),
        "dx": (bw.transpose_conv2d_dx, bw.transpose_conv2d_dx_plain),
        "dw": (bw.transpose_conv2d_dw, bw.transpose_conv2d_dw_plain),
    }
    return {name: every[name] for name in names}


def epilogues():
    """Every epilogue: none, bias, and bias with each activation."""
    from repro_torch.kernels.epilogue import Epilogue

    return [None, Epilogue(True), Epilogue(True, "relu"), Epilogue(True, "tanh"),
            Epilogue(True, "leaky_relu", 0.2)]


def phase_check(torch) -> dict:
    epis = epilogues()
    worst = {}
    for name, (launch, plain) in kernels(FORWARD).items():
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
        for name, (launch, plain) in kernels(FORWARD).items():
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


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name. Only the device's own events
    count: a host-side range (an aten op, an autograd Function) also
    reports the device time of the kernels it launched, which would count
    them twice."""
    from torch.autograd import DeviceType

    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


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
        dev = _kernel_times(prof)
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

    launchers = {name: fns[0] for name, fns in kernels(FORWARD).items()}
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


def _bwd_inputs(torch, shape, seed):
    """x, kernel, bias and a cotangent ``g`` of the layer's output."""
    x, k, bias = _inputs(torch, shape, seed)
    b, n_in, n_k, pad, _, cout = shape
    m = 2 * n_in - n_k + 2 * pad
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return x, k, bias, torch.randn((b, m, m, cout), device="cuda", generator=gen)


def _worst(name, shape, tag, pairs, worst) -> None:
    """Raise unless each (kernel, plain) pair agrees within the tolerance;
    keep the worst error per kernel."""
    for got, want in pairs:
        err = (got - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        if not (got.shape == want.shape and err <= tol):
            raise AssertionError(f"{name} kernel disagrees with its plain version "
                                 f"at {shape} {tag}: {err} > {tol}")
        worst[name] = max(worst[name], err)


def phase_bwd_check(torch) -> dict:
    """Each backward kernel against its plain version. The plain forward
    gives ``y``; the plain epilogue-grad gives the ``gm`` that both dx and
    dw versions take, so each error is the kernel's own."""
    from repro_torch.kernels import transpose_conv2d as tcf

    bwd = kernels(("epilogue_grad", "dx", "dw"))
    worst = dict.fromkeys(bwd, 0.0)
    for i, shape in enumerate(DCGAN_SHAPES + ODD_SHAPES):
        x, k, bias, g = _bwd_inputs(torch, shape, seed=200 + i)
        b, n_in, n_k, pad, _, _ = shape
        for epi in epilogues():
            tag = epi.tag() if epi else "none"
            with_db = epi is not None and epi.bias
            y = tcf.transpose_conv2d_fused_plain(x, k, pad, epilogue=epi,
                                                 bias=bias if epi else None)
            gm = bwd["epilogue_grad"][1](g, y, epi)
            _worst("epilogue_grad", shape, tag,
                   [(bwd["epilogue_grad"][0](g, y, epi), gm)], worst)
            _worst("dx", shape, tag,
                   [(bwd["dx"][0](gm, k, n_in, pad), bwd["dx"][1](gm, k, n_in, pad))],
                   worst)
            got = bwd["dw"][0](x, gm, n_k, pad, with_db=with_db)
            want = bwd["dw"][1](x, gm, n_k, pad, with_db=with_db)
            _worst("dw", shape, tag,
                   list(zip(got, want)) if with_db else [(got, want)], worst)
        torch.cuda.synchronize()
        log(f"[bwd-check] {shape}: every epilogue within tolerance; worst so far "
            + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))
    return worst


def _live(params):
    return {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}


def phase_autograd(torch) -> dict:
    """The generator's parameter gradients through the backward kernels
    against the plan pinned to ``bwd="autograd"``."""
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hw, c = cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2]
    z = torch.randn((BATCH, cfg.z_dim), device="cuda", generator=gen)
    r = torch.randn((BATCH, hw, hw, c), device="cuda", generator=gen)
    grads = {}
    for bwd in ("segregated", "autograd"):
        live = _live(params)
        plan = gan.generator_plan(cfg, BATCH, bwd=bwd)
        (gan.generator_apply(live, cfg, z, plan=plan) * r).sum().backward()
        grads[bwd] = {f"{k}.{n}": t.grad for k, v in live.items()
                      for n, t in v.items()}
    out = {}
    for key, want in grads["autograd"].items():
        got = grads["segregated"][key]
        err = (got - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        out[key] = {"max_abs_err": err, "tol": tol}
        log(f"[autograd] d{key}: segregated vs autograd max abs err {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"generator gradient {key}: {err} > {tol}")
    return out


def _bwd_bounds(shape) -> dict:
    """Least times of the three backward kernels at ``shape``: dx and dw do
    the forward's MACs; epilogue-grad reads g and y and writes gm."""
    from repro_torch.core.segregation import flop_count, output_size

    b, n_in, n_k, pad, cin, cout = shape
    m = output_size(n_in, n_k, pad)
    flops = 2 * b * flop_count(n_in, n_k, cin, cout, pad)
    x_b, g_b, w_b = 4 * b * n_in * n_in * cin, 4 * b * m * m * cout, 4 * n_k * n_k * cin * cout

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BPS * 1e3
        return {"flops": ops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    return {"dx": bound(flops, g_b + w_b + x_b),
            "dw": bound(flops, x_b + g_b + w_b + 4 * cout),
            "epilogue_grad": bound(3 * b * m * m * cout, 3 * g_b)}


def phase_bwd_times(torch) -> list:
    """Per DCGAN layer at batch 8, by CUDA events: each backward kernel,
    its plain version, one library call of the same function (never called
    by the port) and the bound."""
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels.transpose_conv2d import transpose_conv2d_fused
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    conv_bwd = torch.ops.aten.convolution_backward
    rows = []
    for i, shape in enumerate(DCGAN_SHAPES):
        b, n_in, n_k, pad, cin, cout = shape
        x, k, bias, g = _bwd_inputs(torch, shape, seed=300 + i)
        epi = gan.generator_epilogues(gan.DCGAN)[i]
        y = transpose_conv2d_fused(x, k, pad, epilogue=epi, bias=bias)
        gm = bw.epilogue_grad(g, y, epi)
        # the F.conv_transpose2d form: NCHW, flipped (Cin, Cout, n, n) kernel
        g_nchw = gm.permute(0, 3, 1, 2).contiguous()
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        pt = n_k - 1 - pad
        conv_args = (g_nchw, x_nchw, w_t, [cout], [2, 2], [pt, pt], [1, 1], True,
                     [0, 0], 1)
        if epi.act == "tanh":
            def eager(gg, yy):
                return gg * (1 - yy * yy)
        else:
            def eager(gg, yy):
                return torch.where(yy > 0, gg, 0.0)
        row = {"layer": f"L{i}", "shape": shape, "act": epi.act,
               "bounds": _bwd_bounds(shape),
               "epilogue_grad_ms": time_cuda(bw.epilogue_grad, g, y, epi),
               "epilogue_grad_plain_ms": time_cuda(bw.epilogue_grad_plain, g, y, epi,
                                                   iters=5),
               "epilogue_grad_library_ms": time_cuda(eager, g, y),
               "dx_ms": time_cuda(bw.transpose_conv2d_dx, gm, k, n_in, pad),
               "dx_plain_ms": time_cuda(bw.transpose_conv2d_dx_plain, gm, k, n_in,
                                        pad, iters=5),
               "dx_library_ms": time_cuda(conv_bwd, *conv_args, [True, False, False]),
               "dw_ms": time_cuda(bw.transpose_conv2d_dw, x, gm, n_k, pad,
                                  with_db=True),
               "dw_plain_ms": time_cuda(bw.transpose_conv2d_dw_plain, x, gm, n_k, pad,
                                        with_db=True, iters=5),
               "dw_library_ms": time_cuda(conv_bwd, *conv_args, [False, True, True]),
               "geometry": {"dx_splits": bw.bwd_geometry(*shape).dx_splits,
                            "dw_splits": bw.bwd_geometry(*shape).dw_splits}}
        # the events above also hold each call's host cost where that
        # exceeds the kernel's; the profiler gives the device's own time
        row["device_us"] = {
            "epilogue_grad": _device_us(torch, bw.epilogue_grad, g, y, epi),
            "dx": _device_us(torch, bw.transpose_conv2d_dx, gm, k, n_in, pad),
            "dw": _device_us(torch, bw.transpose_conv2d_dw, x, gm, n_k, pad,
                             with_db=True),
            "epilogue_grad_library": _device_us(torch, eager, g, y),
            "dx_library": _device_us(torch, conv_bwd, *conv_args, [True, False, False]),
            "dw_library": _device_us(torch, conv_bwd, *conv_args, [False, True, True]),
        }
        rows.append(row)
        log(f"[bwd-times] L{i} {shape}: " + " | ".join(
            f"{n} {row[n + '_ms'] * 1e3:.2f} us (plain {row[n + '_plain_ms'] * 1e3:.2f},"
            f" library {row[n + '_library_ms'] * 1e3:.2f}, bound "
            f"{row['bounds'][n]['bound_ms'] * 1e3:.2f} {row['bounds'][n]['bound_by']})"
            for n in ("epilogue_grad", "dx", "dw")) + f" splits {row['geometry']}")
        log(f"[bwd-times] L{i} device-only us by the profiler: {row['device_us']}")
    return rows


def _device_us(torch, fn, *args, calls: int = 5, **kwargs) -> float:
    """Device microseconds per call of ``fn`` (every kernel it launches,
    the reduce pass included), from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args, **kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    return sum(_kernel_times(prof).values()) / calls


class _NanAt:
    """Data whose batch is all NaN at the given step indices."""

    def __init__(self, data, steps):
        self.data, self.steps = data, set(steps)

    def batch(self, i):
        x = self.data.batch(i)
        return x.new_full(x.shape, float("nan")) if i in self.steps else x


def _counters():
    from repro_torch.kernels import transpose_conv2d_bwd as bw

    wrappers = {name: fns[0] for name, fns in kernels().items()}
    return wrappers, {"dx_reduce": bw.transpose_conv2d_dx,
                      "dw_reduce": bw.transpose_conv2d_dw}


def _reset_counts() -> None:
    wrappers, reducers = _counters()
    for fn in wrappers.values():
        fn.launches = 0
    for fn in reducers.values():
        fn.reduce_launches = 0


def _read_counts() -> dict:
    wrappers, reducers = _counters()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({name: fn.reduce_launches for name, fn in reducers.items()})
    return counts


def _bitwise(a, b) -> bool:
    """Every leaf of two states equal in dtype, shape and bits."""
    import torch

    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def phase_train(torch) -> dict:
    """GanTrainer on full-width DCGAN, with deterministic algorithms on:
    the path's checks, then timings."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticImages
    from repro_torch.models import gan
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from repro_torch.tree import tree_map

    torch.use_deterministic_algorithms(True)
    # deterministic mode would also fill every torch.empty with NaN: a
    # debugging aid that adds a fill kernel to each wrapper's output
    torch.utils.deterministic.fill_uninitialized_memory = False
    _log_determinism(torch, "train")
    cfg = gan.DCGAN
    tcfg = GanTrainerConfig(ckpt_every=3)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                           tcfg.global_batch)
    quiet = lambda *a: None  # noqa: E731

    def trainer(ckpt_dir=None, d=data, bwd=None):
        tr = GanTrainer(cfg, tcfg, d, ckpt_dir=ckpt_dir, log_fn=quiet)
        if bwd is not None:
            tr.train_plan = gan.generator_plan(cfg, tr.micro, bwd=bwd)
        return tr, tr.init_state(torch.Generator().manual_seed(0))

    out = {"plan": gan.generator_plan(cfg, tcfg.global_batch).describe()}
    log("[train] " + out["plan"].replace("\n", "\n[train] "))
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        tr, state = trainer(d1)
        _reset_counts()
        full, hist = tr.run(state, steps=6)
        torch.cuda.synchronize()
        launches = _read_counts()
        if not all(np.isfinite([h["g_loss"], h["d_loss"]]).all() and not h["skipped"]
                   for h in hist):
            raise AssertionError(f"non-finite or skipped step: {hist}")
        if min(launches[n] for n in SOURCES) < 1:
            raise AssertionError(f"a kernel of the training path never launched: "
                                 f"{launches}")
        log(f"[train] 6 steps, losses {[(h['g_loss'], h['d_loss']) for h in hist]}")
        log(f"[train] launches in those 6 steps {launches}")
        shutil.copy(os.path.join(d1, "step_00000003.npz"), d2)
        tr2, state = trainer(d2)
        resumed, hist2 = tr2.run(state, steps=6)
        if tr2.resumed_step != 3 or hist2 != hist[3:] or not _bitwise(resumed, full):
            raise AssertionError(
                f"resume from step 3 is not bitwise the uninterrupted run: "
                f"{hist2} vs {hist[3:]}")
        log("[train] resume from step 3: losses, params and moments bitwise equal "
            "to the uninterrupted run")
    tr3, state = trainer(d=_NanAt(data, (0,)))
    before = tree_map(torch.clone, state)
    after, hist3 = tr3.run(state, steps=1)
    if hist3[0]["skipped"] != 1 or tr3.skipped_steps != 1 or not _bitwise(before, after):
        raise AssertionError("a NaN step changed the state or was not skipped")
    log("[train] NaN step skipped, state bitwise untouched, skipped_steps 1")
    out.update({"launches_6_steps": launches, "losses": hist, "resume_bitwise": True,
                "nan_step_skipped": True})

    tr, _ = trainer()
    tr._batches(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        tr._batches(i)
    torch.cuda.synchronize()
    out["inputs_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    log(f"[train] drawing a step's reals and latents on the card: "
        f"{out['inputs_ms_per_step']:.4f} ms a step (host clock, {TRAIN_TIMED_STEPS} "
        f"steps, one sync)")

    steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    windows = {"segregated": [], "autograd": []}
    for w in range(TRAIN_WINDOWS):   # alternate, so drift hits both alike
        for bwd in windows:
            tr, state = trainer(bwd=bwd)
            _reset_counts()
            state, _ = tr.run(state, steps=steps)
            counts = _read_counts()
            walls = np.asarray(tr.timer.steps[TRAIN_WARMUP_STEPS:]) * 1e3
            windows[bwd].append({
                "step_ms_median": float(np.median(walls)),
                "step_ms_p90": float(np.percentile(walls, 90)),
                "step_ms": walls.tolist(),
                "launches_per_step": {n: c / steps for n, c in counts.items()}})
            log(f"[train] window {w} bwd={bwd}: {TRAIN_TIMED_STEPS} steps after "
                f"{TRAIN_WARMUP_STEPS} warm-up, step ms median "
                f"{windows[bwd][-1]['step_ms_median']:.3f} p90 "
                f"{windows[bwd][-1]['step_ms_p90']:.3f} (host clock; each step "
                f"ends in a sync), launches per step "
                f"{windows[bwd][-1]['launches_per_step']}")
            if bwd == "segregated" and w == 0:   # one profiled step
                reals, zs = tr._batches(steps)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    tr._step_fn(state, reals, zs)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                dev = _kernel_times(prof)
                busy = sum(dev.values())
                top = sorted(dev.items(), key=lambda kv: -kv[1])[:15]
                out["profile"] = {"wall_us": wall_us, "device_us": busy,
                                  "idle_share": 1 - busy / wall_us,
                                  "top": [[n[:90], us] for n, us in top]}
                log(f"[train] profiled step: device {busy:.1f} us of "
                    f"{wall_us:.1f} us wall, idle share {1 - busy / wall_us:.3f}")
                for name, us in top:
                    log(f"[train]   {us:9.1f} us  {name[:90]}")
    out["windows"] = windows
    return out


def _entry(name, launches, err, rows, times_of, bound_of) -> dict:
    """One kernel's line of the result: times summed over the DCGAN layers
    it runs at batch 8 (``rows``; ``times_of(row, suffix)`` and
    ``bound_of(row)`` read them)."""
    ops = sum(bound_of(r)["ops_ms"] for r in rows)
    byt = sum(bound_of(r)["bytes_ms"] for r in rows)
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": sum(times_of(r, "_ms") for r in rows),
        "plain_ms": sum(times_of(r, "_plain_ms") for r in rows),
        "bound_ms": sum(bound_of(r)["bound_ms"] for r in rows),
        "bound_by": "operations" if ops >= byt else "bytes",
        "library_ms": sum(times_of(r, "_library_ms") for r in rows),
    }


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace, set before it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    worst.update(phase_bwd_check(torch))
    grads = phase_autograd(torch)
    bwd_times = phase_bwd_times(torch)
    train = phase_train(torch)

    entries = []
    for name in FORWARD:   # launches: the serving run of phase 5
        rows = [r for r in times["layers"] if r["path"] == name]
        entries.append(_entry(
            name, engine["launches"][name], worst[name], rows,
            lambda r, k, n=name: r["library_ms" if k == "_library_ms" else n + k],
            lambda r: r))
    for name in ("epilogue_grad", "dx", "dw"):   # launches: the 6-step training run
        entries.append(_entry(name, train["launches_6_steps"][name], worst[name],
                              bwd_times, lambda r, k, n=name: r[n + k],
                              lambda r, n=name: r["bounds"][n]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "kernels": entries, "times": times,
                   "profile": profiled, "engine": engine, "projection": projection,
                   "serving": serving, "max_abs_err": worst, "grads": grads,
                   "bwd_times": bwd_times, "train": train,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
