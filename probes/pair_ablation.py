#!/usr/bin/env python3
"""Where the pair kernel's time goes: device µs of the DCGAN pairs with
parts of csrc/transpose_conv2d_pair.cu switched off, on the card.

    python3 probes/pair_ablation.py

Run from the root of a checkout. Builds variants of the (R = 2, d = 1)
instance from a copy of the source with switches inserted at fixed lines
(it stops if a line has moved): the producer or the consumer alone, each
with its FMAs off (staging alone) or its copies off (the micro-tile
alone), the consumer reading its own shared memory in place of its owners'
(no remote reads), and the consumer's register prefetch off. A variant
with parts off computes wrong values; only its time is read. Times each by
graph replay (``chip_smoke._device_us``) at batch 1 and 8, the full kernel
and the variants in turns, twice.
"""
import ctypes
import os
import subprocess
import sys

SRC = "src/repro_torch/kernels/csrc/transpose_conv2d_pair.cu"
OUT = "build/probes"
SWITCHES = [  # (line of the source, its guarded form)
    ("      stage_x(xs, st, 0);\n", "#ifndef NO_X\n      stage_x(xs, st, 0);\n#endif\n"),
    ("      stage_x(nxs, next, 0);\n", "#ifndef NO_X\n      stage_x(nxs, next, 0);\n#endif\n"),
    ("      stage_weights<R>(xs + f.stage_x, w, f, n_k, co0, st, vec_w);\n",
     "#ifndef NO_W\n      stage_weights<R>(xs + f.stage_x, w, f, n_k, co0, st, vec_w);\n#endif\n"),
    ("      stage_weights<R>(nxs + f.stage_x, w, f, n_k, co0, next, vec_w);\n",
     "#ifndef NO_W\n      stage_weights<R>(nxs + f.stage_x, w, f, n_k, co0, next, vec_w);\n"
     "#endif\n"),
    ("    if (active)\n      tconv::mac_c4",
     "#ifdef NO_MAC\n    if (active && k < 0)\n#else\n    if (active)\n#endif\n      tconv::mac_c4"),
    ("          const float* owner = cluster.map_shared_rank(iface, group * a.n_bands + band);",
     "#ifdef LOCAL_X\n          const float* owner = iface;\n#else\n"
     "          const float* owner = cluster.map_shared_rank(iface, group * a.n_bands + band);"
     "\n#endif"),
    ("constexpr int kPrefetch = 2;",
     "#ifdef NO_PREFETCH\nconstexpr int kPrefetch = 0;\n#else\nconstexpr int kPrefetch = 2;\n#endif"),
    ("      float4 pf[kPrefetch];", "      float4 pf[kPrefetch > 0 ? kPrefetch : 1];"),
    ("  // ---- 1. producer: this block's interface quads, halo zeros around them\n",
     "#ifndef NO_PROD\n"),
    ("  // ---- 2. every block's interface is complete and visible to the cluster\n",
     "#endif\n"),
    ("  // ---- 3. consumer: work tiles of the output, round-robin over the blocks\n",
     "#ifndef NO_CONS\n"),
    ("  // ---- 4. no block leaves while another may still read its interface\n", "#endif\n"),
]
VARIANTS = {
    "full": [],
    "no_prefetch": ["-DNO_PREFETCH"],
    "producer": ["-DNO_CONS"],
    "producer_staging": ["-DNO_CONS", "-DNO_MAC"],
    "producer_fma": ["-DNO_CONS", "-DNO_W", "-DNO_X"],
    "consumer": ["-DNO_PROD"],
    "consumer_staging": ["-DNO_PROD", "-DNO_MAC"],
    "consumer_fma": ["-DNO_PROD", "-DNO_W", "-DNO_X"],
    "consumer_local": ["-DNO_PROD", "-DLOCAL_X"],
}


def main() -> int:
    sys.path[:0] = ["src", "."]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import transpose_conv2d_pair as tp
    from repro_torch.kernels.epilogue import Epilogue

    cs.phase_device(torch)
    src = open(SRC).read().replace(
        '#include "tconv_microkernel.cuh"',
        f'#include "{os.path.abspath("src/repro_torch/kernels/csrc/tconv_microkernel.cuh")}"')
    for line, guarded in SWITCHES:
        if line not in src:
            raise SystemExit(f"the source no longer has the line {line!r}")
        src = src.replace(line, guarded)
    for rd in ("(1, 0)", "(1, 1)", "(2, 0)", "(3, 0)", "(3, 1)", "(4, 0)", "(4, 1)"):
        src = src.replace(f"PAIR_CASE{rd}", "")   # build the (2, 1) instance only
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "pair_ablation.cu")
    open(cu, "w").write(src)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
         os.path.join(OUT, f"pair_{name}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        fn = ctypes.CDLL(os.path.abspath(os.path.join(OUT, f"pair_{name}.so"))).tconv_pair_f32
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = fn
    relu, tanh = Epilogue(True, "relu"), Epilogue(True, "tanh")
    for i, shape in enumerate(cs.DCGAN_PAIRS):
        _, n_in, n_k, pad, c0, c1, c2 = shape
        g = tp.pair_launch_geometry(n_in, n_k, pad, c0, c1, c2)
        x, k1, k2, b1, b2 = cs._pair_inputs(torch, shape, seed=i)
        e2 = tanh if i == len(cs.DCGAN_PAIRS) - 1 else relu
        for batch in (1, 8):
            xb = x[:batch].contiguous()
            out = torch.empty((batch, g.m2, g.m2, c2), device="cuda")
            ints = g.geometry_ints(batch) + [int(c % 4 == 0) for c in (c0, c1, c2)] + [
                relu.code, e2.code]
            geo = (ctypes.c_int * len(ints))(*ints)

            def call(fn):
                err = fn(xb.data_ptr(), k1.data_ptr(), k2.data_ptr(), b1.data_ptr(),
                         b2.data_ptr(), out.data_ptr(), ctypes.cast(geo, ctypes.c_void_p),
                         len(ints), g.r, g.d, 0.0, 0.0, g.smem_bytes,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    times[name].append(cs._device_us(torch, call, libs[name]))
            print(f"{shape[1:]} batch {batch}: " + ", ".join(
                f"{name} {sum(t) / len(t):.1f}" for name, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
