#!/usr/bin/env python3
"""Variants of the implicit-GEMM and dx kernels on the card: registers and
spills of each, and device µs at the DCGAN shapes the main path runs.

    python3 probes/gemm_dx_sweep.py

Run from the root of a checkout. Each variant is an edited copy of the
checkout's own source (the probe stops if a line it edits has moved),
compiled with the build's own flags into ``build/probes/`` and bound in
place of the wrapper's library, with the Python constants that describe it
set alongside; every variant is checked against the plain version before
it is timed. The variants:

- ``gemm runtime_slice_loop``: the slice loop with a run-time start
  (``for (kq = ksl; ...; kq += KS)``) in place of the fixed two trips;
  ``dx two_blocks_an_sm``: ``__launch_bounds__(256, 2)`` (128 registers);
- ``gemm stages=4``, ``dx stages=3``: the other ring depth;
- ``dx poor np=N ct=C``: N positions a thread, C Cin a block;
- ``gemm min_blocks=B``, ``dx min_blocks=B``: the split targets (no edit
  to the source: the split count is an argument).

Each is timed by graph replay (``chip_smoke._device_us``), the variants in
turns, twice. Results go to stdout and ``chiprun_out/gemm_dx_sweep.json``.
"""
import ctypes
import json
import os
import subprocess
import sys

OUT = "build/probes"
GEMM_SHAPES = [(1, 4, 4, 2, 1024, 512), (8, 4, 4, 2, 1024, 512)]   # DCGAN L0, b1 and b8
DX_RICH = [(8, 4, 4, 2, 1024, 512), (8, 8, 4, 2, 512, 256), (8, 16, 4, 2, 256, 128)]
DX_POOR = [(8, 32, 4, 2, 128, 3), (8, 32, 4, 2, 64, 3)]   # DCGAN L3, GP-GAN L3


def _edit(text, old, new):
    if old not in text:
        raise SystemExit(f"the line to edit has moved: {old!r}")
    return text.replace(old, new)


def main() -> int:
    root = os.getcwd()
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels import transpose_conv2d_gemm as tcg
    from repro_torch.kernels.epilogue import Epilogue

    if not torch.cuda.is_available():
        print("gemm_dx_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    csrc = _build.CSRC
    gemm = (csrc / "transpose_conv2d_gemm.cu").read_text()
    bwd = (csrc / "transpose_conv2d_bwd.cu").read_text()
    fixed_loop = ("    for (int h = 0; h < BK / 4 / KS; ++h) {   // this slice's 4-channel "
                  "groups\n      const int kq = ksl + KS * h;\n")
    # name: (source kind, text, Python constants {module attribute: value})
    variants = {
        "gemm base": ("gemm", gemm, {}),
        "gemm runtime_slice_loop": ("gemm", _edit(
            gemm, fixed_loop, "    for (int kq = ksl; kq < BK / 4; kq += KS) {\n"), {}),
        "gemm stages=4": ("gemm", _edit(gemm, "constexpr int STAGES = 3;",
                                        "constexpr int STAGES = 4;"), {"STAGES": 4}),
        "dx base": ("bwd", bwd, {}),
        "dx two_blocks_an_sm": ("bwd", _edit(bwd, "__launch_bounds__(DX_THREADS)\ndx_kernel",
                                             "__launch_bounds__(DX_THREADS, 2)\ndx_kernel"), {}),
        "dx stages=3": ("bwd", _edit(bwd, "constexpr int DX_STAGES = 4;",
                                     "constexpr int DX_STAGES = 3;"), {"DX_STAGES": 3}),
    }
    for np_, ct in ((4, 32), (4, 64), (8, 64)):
        text = _edit(_edit(bwd, "constexpr int DXP_NP = 8;", f"constexpr int DXP_NP = {np_};"),
                     "constexpr int DXP_CT = 32;", f"constexpr int DXP_CT = {ct};")
        variants[f"dx poor np={np_} ct={ct}"] = ("bwd", text, {
            "DX_POOR_NP": np_, "DX_TILES": {**bw.DX_TILES, "poor": (256 // (ct // 4) * np_, ct)}})
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, (_, text, _)) in enumerate(variants.items()):
        path = os.path.join(OUT, f"variant{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), path[:-3] + ".so")
    registers = {}
    for name, (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        registers[name] = {
            ("dx_poor_kernel<2>" if "dx_poor_kernelILi2" in fn
             else "dx_kernel" if "dx_kernel" in fn else "gemm_kernel"):
            [rep["registers"], rep["spill_stores"]]
            for fn, rep in _build.ptxas_report(log).items()
            if "gemm_kernel" in fn or "dx_kernel" in fn or "dx_poor_kernelILi2" in fn}
        print(f"[registers, spill bytes] {name}: {registers[name]}", flush=True)

    epi = Epilogue(True, "relu")
    real_gemm, real_bwd = tcg._lib(), bw._lib()
    saved = {tcg: {k: getattr(tcg, k) for k in ("_lib", "STAGES", "MIN_BLOCKS")},
             bw: {k: getattr(bw, k) for k in ("_lib", "DX_STAGES", "DX_POOR_NP",
                                              "DX_TILES", "DX_MIN_BLOCKS")}}

    def bind(name, consts):
        kind = variants[name][0] if name in variants else name.split()[0]
        so = procs[name][1] if name in procs else procs[f"{kind} base"][1]
        lib = ctypes.CDLL(so)
        for mod, consts0 in saved.items():
            for k, v in consts0.items():
                setattr(mod, k, v)
        if kind == "gemm":
            fn = lib.tconv_gemm_f32
            fn.argtypes, fn.restype = real_gemm.argtypes, ctypes.c_int
            tcg._lib = lambda: fn
        else:
            for f in ("tconv_dx_f32", "tconv_sum_splits_f32"):
                getattr(lib, f).argtypes = getattr(real_bwd, f).argtypes
                getattr(lib, f).restype = ctypes.c_int
            bw._lib = lambda: lib
        for k, v in consts.items():
            setattr(tcg if kind == "gemm" else bw, k, v)
        tcg.gemm_geometry.cache_clear()
        bw.bwd_geometry.cache_clear()
        return kind

    def run(kind, shapes):
        out = []
        for shape in shapes:
            if kind == "gemm":
                x, k, b = cs._inputs(torch, shape, 4)
                args, kw = (x, k, shape[3]), dict(epilogue=epi, bias=b)
                fn, plain = tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain
                splits = tcg.gemm_geometry(*shape).splits
            else:
                _, k, _, g = cs._bwd_inputs(torch, shape, 5)
                args, kw = (g, k, shape[1], shape[3]), {}
                fn, plain = bw.transpose_conv2d_dx, bw.transpose_conv2d_dx_plain
                splits = bw.bwd_geometry(*shape).dx_splits
            got, want = fn(*args, **kw), plain(*args, **kw)
            err = (got - want).abs().max().item()
            if not err <= 1e-4 * want.abs().max().item() + 1e-5:
                raise SystemExit(f"{kind} variant disagrees at {shape}: {err}")
            out.append({"shape": shape, "splits": splits,
                        "us": cs._device_us(torch, fn, *args, **kw)})
        return out

    runs = [(name, consts, GEMM_SHAPES if kind == "gemm"
             else DX_POOR if "poor" in name else DX_RICH + DX_POOR)
            for name, (kind, _, consts) in variants.items()]
    runs += [(f"gemm min_blocks={n}", {"MIN_BLOCKS": n}, GEMM_SHAPES)
             for n in (132, 396, 528)]
    runs += [(f"dx min_blocks={n}", {"DX_MIN_BLOCKS": n}, DX_RICH) for n in (264,)]
    results = {name: [] for name, _, _ in runs}
    for rep in range(2):
        for name, consts, shapes in runs:
            kind = bind(name, consts)
            results[name].append(run(kind, shapes))
            print(f"[us] {name} (turn {rep}): " + ", ".join(
                f"{r['shape'][0]}x{r['shape'][1]}x{r['shape'][4]}->{r['shape'][5]} "
                f"splits {r['splits']}: {r['us']:.2f}" for r in results[name][-1]),
                flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "gemm_dx_sweep.json"), "w") as f:
        json.dump({"device": smi, "registers": registers, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
