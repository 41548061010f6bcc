#!/usr/bin/env python3
"""Where the decode-attention kernel's time goes: device µs of the split
pass with parts switched off, the combine pass alone, each instance's
registers and the blocks an SM holds, on the card.

    python3 probes/decode_ablation.py [SOURCE]

Run from the root of a checkout. SOURCE is a decode_attention.cu, by
default the checkout's own; the earlier two-pass design is read from an
older tree's file, e.g. ``git show 44da5ae:src/repro_torch/kernels/csrc/
decode_attention.cu > build/decode_two_pass.cu``. The probe recognises the
design by its lines and inserts switches at them (it stops if a line has
moved):

- two-pass (commit 44da5ae): ``k`` the K pass alone, ``v`` the V pass alone,
  ``no_softmax`` both passes without the softmax between them;
- one-pass (bf16): ``k`` the K tiles and the score mmas (no V
  copies, no exponentials, no P.V), ``v`` the V tiles and the P.V mmas (no
  K copies, no score mmas, no exponentials), ``no_softmax`` everything but
  the exponentials of P.

A variant with parts off computes wrong values; only its time is read.
Each is timed by graph replay (``chip_smoke._device_us``) at
chip_smoke's DECODE_TIMES and the served shape (bf16, kv_len = S), in
turns, twice; ``combine`` is the second pass alone. Registers come from
``-Xptxas -v``, blocks an SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.
"""
import ctypes
import os
import subprocess
import sys

DEFAULT = "src/repro_torch/kernels/csrc/decode_attention.cu"
OUT = "build/probes"
SHAPES = [(8, 1024, 8, 4, 128)]   # the served shape; DECODE_TIMES follow
DESIGNS = {
    "two-pass": {
        "marker": "  // Pass 1: scores of the split's positions.\n",
        "switches": [
            ("  // Pass 1: scores of the split's positions.\n",
             "#ifndef NO_K\n  // Pass 1: scores of the split's positions.\n"),
            ("  // Softmax over the split: one warp a query row.\n",
             "#endif\n#ifndef NO_SOFTMAX\n  // Softmax over the split: one warp a query row.\n"),
            ("  // Pass 2: acc[g] = sum_t p[g][t] v[t], this lane's slice of hd.\n",
             "#endif\n  // Pass 2: acc[g] = sum_t p[g][t] v[t], this lane's slice of hd.\n"),
            ("  for (int base = 0; base < n; base += chunk) {\n    float vv[UNROLL][VEC];\n",
             "#ifndef NO_V\n  for (int base = 0; base < n; base += chunk) {\n"
             "    float vv[UNROLL][VEC];\n"),
            ("  // across the warp's position groups (lanes a position apart)\n",
             "#endif\n  // across the warp's position groups (lanes a position apart)\n"),
        ],
    },
    "one-pass": {
        "marker": "    // scores of this warp's TW positions, scaled, -inf at or past kv_len;\n",
        "switches": [
            ("    cp_async16(ks + t * pitch + 16 * c, kb + off, in);\n",
             "#ifndef NO_K\n    cp_async16(ks + t * pitch + 16 * c, kb + off, in);\n#endif\n"),
            ("    cp_async16(vs + t * pitch + 16 * c, vb + off, in);\n",
             "#ifndef NO_V\n    cp_async16(vs + t * pitch + 16 * c, vb + off, in);\n#endif\n"),
            ("          if (16 * s < hd)\n            mma_bf16(c4, qa[s][0], qa[s][1],",
             "#ifdef NO_K\n          if (false)\n#else\n          if (16 * s < hd)\n#endif\n"
             "            mma_bf16(c4, qa[s][0], qa[s][1],"),
            ("        sc[blk][0] = expf(sc[blk][0] - m_new);\n        sc[blk][1] = expf(sc[blk][1] - m_new);\n",
             "#ifndef NO_SOFTMAX\n        sc[blk][0] = expf(sc[blk][0] - m_new);\n"
             "        sc[blk][1] = expf(sc[blk][1] - m_new);\n#endif\n"),
            ("#pragma unroll\n      for (int ksv = 0; ksv < kMaxBlocks / 2; ++ksv) {\n",
             "#pragma unroll\n      for (int ksv = 0; ksv < kMaxBlocks / 2; ++ksv) {\n"
             "#ifdef NO_V\n        break;\n#endif\n"),
        ],
    },
}
VARIANTS = {"full": [], "k": ["-DNO_V", "-DNO_SOFTMAX"], "v": ["-DNO_K", "-DNO_SOFTMAX"],
            "no_softmax": ["-DNO_SOFTMAX"]}
OCCUPANCY = {  # appended to each copy: blocks an SM of each bf16 instance
    "two-pass": """
extern "C" int probe_blocks_per_sm(int max_g, int hd, int threads, int smem) {
  int n = -1;
  switch (max_g) {
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 1>, threads, smem); break;
    case 2: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 2>, threads, smem); break;
    case 4: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 4>, threads, smem); break;
    case 8: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 8>, threads, smem); break;
  }
  return n;
}
""",
    "one-pass": """
extern "C" int probe_blocks_per_sm(int max_g, int hd, int threads, int smem) {
  int n = -1;
  if (hd <= 64) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 8, 64>, threads, smem);
  else if (hd <= 128) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 8, 128>, threads, smem);
  else cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_kernel<__nv_bfloat16, 8, 256>, threads, smem);
  return n;
}
""",
}


def _two_pass_geometry(s_len, hd, g):
    """The two-pass design's decode_geometry for bf16: 256 positions a
    split, 4 warps, 4 positions a lane in flight, 8 elements a lane."""
    lanes = 1
    while lanes * 8 < hd:
        lanes *= 2
    ppw = 32 // lanes
    max_g = 1
    while max_g < g:
        max_g *= 2
    split_len = 256
    smem = 4 * (g * hd + g * max(split_len, 4 * hd) + 2 * g)
    return {"lanes": lanes, "ppw": ppw, "step": 4 * ppw, "chunk": 16 * ppw,
            "split_len": split_len, "n_splits": -(-s_len // split_len),
            "max_g": max_g, "smem": smem, "threads": 128}


def main() -> int:
    sys.path[:0] = ["src", "."]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    cs.phase_device(torch)
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    src = open(path).read()
    design = next(n for n, d in DESIGNS.items() if d["marker"] in src)
    spec = DESIGNS[design]
    for line, guarded in spec["switches"]:
        if line not in src:
            raise SystemExit(f"the source no longer has the line {line!r}")
        src = src.replace(line, guarded)
    src += OCCUPANCY[design]
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "decode_ablation.cu")
    open(cu, "w").write(src)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
         os.path.join(OUT, f"decode_{name}.so"), cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        if name == "full":
            for fn, rep in _build.ptxas_report(log).items():
                print(f"[ptxas] {fn}: {rep}", flush=True)
        libs[name] = ctypes.CDLL(os.path.abspath(os.path.join(OUT, f"decode_{name}.so")))
    occ = libs["full"].probe_blocks_per_sm
    occ.argtypes = [ctypes.c_int] * 4
    print(f"[probe] {path}: the {design} design", flush=True)
    for shape in SHAPES + cs.DECODE_TIMES:
        b, s_len, kvh, g, hd = shape
        q, k, v, _ = cs._decode_inputs(torch, shape, torch.bfloat16, seed=0)
        kv_len = torch.full((b,), s_len, dtype=torch.int32, device="cuda")
        out = torch.empty((b, kvh, g, hd), device="cuda")
        if design == "two-pass":
            geo = _two_pass_geometry(s_len, hd, g)
            pa = torch.empty((b, kvh, geo["n_splits"], g, hd), device="cuda")
            pm = torch.empty((b, kvh, geo["n_splits"], g, 2), device="cuda")
            split_args = [b, s_len, kvh, g, hd, geo["lanes"], geo["ppw"], geo["step"],
                          geo["chunk"], geo["split_len"], geo["n_splits"]]
            tail = [geo["max_g"], 1, geo["smem"]]
            comb_args = [b, s_len, kvh, g, hd, geo["split_len"], geo["n_splits"]]
        else:
            geo = da.decode_geometry(s_len, hd, g, torch.bfloat16)
            pa = torch.empty((b, kvh, geo.n_splits, g, hd), device="cuda")
            pm = torch.empty((b, kvh, geo.n_splits, g, 2), device="cuda")
            split_args = geo.split_ints(b, kvh)
            tail = [geo.max_g, 1, geo.smem_bytes]
            comb_args = [b, s_len, kvh, g, hd, geo.split_len, geo.n_splits]
            geo = {"max_g": geo.max_g, "smem": geo.smem_bytes, "threads": geo.threads,
                   "n_splits": geo.n_splits}
        ptrs = [t.data_ptr() for t in (q, k, v, kv_len, pa, pm, out)]

        def split(lib):
            stream = torch.cuda.current_stream().cuda_stream   # the capture's
            fn = lib.decode_attention_split
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * len(split_args)
                           + [ctypes.c_float] + [ctypes.c_int] * len(tail) + [ctypes.c_void_p])
            err = fn(*ptrs, *split_args, hd ** -0.5, *tail, stream)
            if err:
                raise RuntimeError(f"split launch failed: CUDA error {err}")

        def combine():
            stream = torch.cuda.current_stream().cuda_stream
            fn = libs["full"].decode_attention_combine
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * len(comb_args) + [
                ctypes.c_void_p]
            err = fn(pa.data_ptr(), pm.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                     *comb_args, stream)
            if err:
                raise RuntimeError(f"combine launch failed: CUDA error {err}")

        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(cs._device_us(torch, split, libs[name]))
        comb = cs._device_us(torch, combine)
        nbytes = 2 * 2 * b * s_len * kvh * hd
        full = sum(times["full"]) / 2
        print(f"{shape} bf16: " + ", ".join(
            f"{name} {sum(t) / len(t):.1f}" for name, t in times.items())
            + f", combine {comb:.1f} us; split pass {nbytes / full / 1e6:.3f} TB/s; "
            f"{geo['n_splits']} splits x {kvh * b} heads; "
            f"{occ(geo['max_g'], hd, geo['threads'], geo['smem'])} blocks an SM", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
