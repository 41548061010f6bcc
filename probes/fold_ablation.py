#!/usr/bin/env python3
"""Where the backward's folded epilogue-grad costs time: device µs of the
dx and dw kernels that apply act'(y) as they stage g, with parts switched
off or done another way, beside the same kernels on gm, at the DCGAN
layers the training step runs (batch 8), on the card.

    python3 probes/fold_ablation.py

Run from the root of a checkout. Each variant is an edited copy of the
checkout's ``transpose_conv2d_bwd.cu`` (the probe stops if a line it edits
has moved), compiled with the build's own flags into ``build/probes/`` and
bound in place of the wrapper's library:

- ``base``: the checkout's source: the rich kernels hold a thread's y
  pieces of the stage in flight in registers and, after the FMAs of the
  stage being read, store g * act'(y) into its slot (dx loads g into
  registers too; dw copies g by cp.async and rewrites it in place);
- ``smem_fold``: the rich kernels as the fold was first specified: y's
  pieces staged by cp.async into a ring of their own, each thread
  rewriting its own staged g pieces in place between its cp.async wait and
  the barrier (the shared memory of an act != 0 launch grows by y's ring);
- ``no_y_load``: the rich kernels take g for y (no y loads; wrong values,
  only its time is read);
- ``ld_pinned``: the rich kernels' g and y loads as volatile PTX, so the
  compiler keeps them where the step's copies are issued;
- ``fold_at_load``: the rich dx kernel forms g * act'(y) as the loads
  return and holds only it until the store;
- ``dw_g_in_registers``: the rich dw kernel loads g into registers beside
  y, as dx does, in place of copying g by cp.async and rewriting it;
- ``rich_act_once``: the rich kernels' folded stores choose act' once for
  the float4, not once a channel;
- ``dw_one_block_an_sm``: the rich dw kernel without its bound of two
  blocks an SM;
- ``dx_poor_fold_every_lane``: every lane of a poor dx position group
  loads and folds every pixel of a window, in place of one lane a pixel
  and the window shared through shared memory;
- ``dx_poor_act_per_pixel``: that, and the run-time act tested at each
  pixel loaded, in place of a walk compiled for each activation;
- ``dx_poor_shfl``: every lane's window, each pixel's loads shared by
  shuffles (lane c loads g's channel c, lane 4 + c y's);
- ``dw_poor_every_lane``: every lane of a poor dw slice loads every g (and
  y) channel, in place of one lane a channel and shuffles.

Every variant that computes right values is held bitwise to the
checkout's three-kernel route (standalone epilogue-grad, then dx and dw on
gm) before it is timed. Each is timed by graph replay
(``chip_smoke._device_us``): the folded dx and dw, and dx and dw on gm (act
0), the variants in turns, twice. Results go to stdout and
``chiprun_out/fold_ablation.json``.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

OUT = "build/probes"
LAYERS = [(8, 4, 4, 2, 1024, 512), (8, 8, 4, 2, 512, 256), (8, 16, 4, 2, 256, 128),
          (8, 32, 4, 2, 128, 3)]   # DCGAN L0-L3 at batch 8


def _edit(text, old, new, count=1):
    if text.count(old) != count:
        raise SystemExit(f"the line to edit has moved: {old!r}")
    return text.replace(old, new)


ACT4_PER_CHANNEL = """__device__ __forceinline__ float4 act_grad4(float4 gv, float4 yv, int act, float slope) {
  return make_float4(act_grad(gv.x, yv.x, act, slope), act_grad(gv.y, yv.y, act, slope),
                     act_grad(gv.z, yv.z, act, slope), act_grad(gv.w, yv.w, act, slope));
}
"""
ACT4_ONCE = """__device__ __forceinline__ float4 act_grad4(float4 gv, float4 yv, int act, float slope) {
  switch (act) {
    case 1: return act_grad4_c<1>(gv, yv, slope);
    case 2: return act_grad4_c<2>(gv, yv, slope);
    case 3: return act_grad4_c<3>(gv, yv, slope);
    default: return gv;
  }
}
"""
LD_QUAD = """  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  v.x = __ldg(src);
  if (n > 1) v.y = __ldg(src + 1);
  if (n > 2) v.z = __ldg(src + 2);
  if (n > 3) v.w = __ldg(src + 3);
"""
LD_QUAD_PINNED = """  if (vec) {
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(src));
    return v;
  }
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v.x) : "l"(src));
  if (n > 1) asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v.y) : "l"(src + 1));
  if (n > 2) asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v.z) : "l"(src + 2));
  if (n > 3) asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v.w) : "l"(src + 3));
"""
DX_POOR_PIXEL = """    if (ACT == 0) return load(g + off);
    return act_grad4_c<ACT>(load(g + off), load(y + off), a.slope);
"""
DX_POOR_PIXEL_RUN_TIME = """    const float4 v = load(g + off);
    return a.act ? act_grad4(v, load(y + off), a.act, a.slope) : v;
"""
DX_POOR_SWITCH = """  switch (a.act) {
    case 1: dx_poor_walk<R, 1>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    case 2: dx_poor_walk<R, 2>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    case 3: dx_poor_walk<R, 3>(g, y, smem, gwin, a, b, i, j0, cq, acc); break;
    default: dx_poor_walk<R, 0>(g, y, smem, gwin, a, b, i, j0, cq, acc);
  }
"""
DX_POOR_SHARED = "      if (ACT == 0) {\n"
DX_POOR_EVERY_LANE = "      if (true) {   // every lane loads (and folds) the whole window\n"
DX_POOR_SHFL = """    const unsigned gmask = 0xffu << (threadIdx.x & 24);
    const int ch = cq & 3;
    float mine = 0.f;
    if (ch < a.Cout && (cq < 4 || ACT)) mine = __ldg((cq < 4 ? g : y) + off + ch);
    if (ACT) mine = act_grad_c<ACT>(mine, __shfl_down_sync(gmask, mine, 4, 8), a.slope);
    return make_float4(__shfl_sync(gmask, mine, 0, 8), __shfl_sync(gmask, mine, 1, 8),
                       __shfl_sync(gmask, mine, 2, 8), __shfl_sync(gmask, mine, 3, 8));
"""
DW_POOR_SHFL = """        float mine = 0.f;
        if (cg < a.Cout) {
          mine = __ldg(g + gp + cg);
          if (a.act) mine = act_grad(mine, __ldg(y + gp + cg), a.act, a.slope);
        }
        float gv[4];
#pragma unroll
        for (int co = 0; co < 4; ++co) gv[co] = __shfl_sync(half, mine, co, 16);
"""
DW_POOR_EVERY_LANE = """        float gv[4];
#pragma unroll
        for (int co = 0; co < 4; ++co) gv[co] = co < a.Cout ? __ldg(g + gp + co) : 0.f;
        if (a.act) {
#pragma unroll
          for (int co = 0; co < 4; ++co)
            gv[co] = act_grad(gv[co], co < a.Cout ? __ldg(y + gp + co) : 0.f, a.act, a.slope);
        }
"""


def _smem_fold(src: str) -> str:
    """The rich kernels as the fold was first specified: g staged by
    cp.async as gm was, y's pieces by cp.async into a ring of their own
    after the stages (same mapping, same zero fill), and each thread
    rewriting its own staged g pieces in place between its cp.async wait and
    the barrier that publishes the stage. The launchers add y's ring to the
    shared memory of an act != 0 launch."""
    text = _edit(src, """    if (FOLD) {
      gr[h] = ld_quad(g + off, n, a.vg);
      yr[h] = ld_quad(y + off, n, a.vg);
    } else {
      cp_quad(as + row * DX_P + 4 * (tid & 3), g + off, g, n, a.vg);
    }""", """    cp_quad(as + row * DX_P + 4 * (tid & 3), g + off, g, n, a.vg);
    if (FOLD) {
      extern __shared__ __align__(16) float smem[];
      float* ys = smem + DX_STAGES * DX_STAGE + (as - smem) / DX_STAGE * (DX_BM * DX_P);
      cp_quad(ys + row * DX_P + 4 * (tid & 3), y + off, y, n, a.vg);
    }""")
    text = _edit(text, """    if (FOLD) yr[j] = ld_quad(y + off, n, a.vw);""", """    if (FOLD) {
      extern __shared__ __align__(16) float smem[];
      float* ys = smem + DW_STAGES * DwTile<BM, BN>::STAGE
                  + (xs - smem) / DwTile<BM, BN>::STAGE * (DW_BK * BN);
      cp_quad(ys + kk * BN + 4 * (lane16 + 16 * j), y + off, y, n, a.vw);
    }""")
    text = _edit(text, "      if (FOLD && st < nk) dx_put(smem + st * DX_STAGE, pg[st], py[st], a);\n",
                 "      ;\n")
    text = _edit(text, "    if (FOLD && next) dx_put(next_slot, gr, yr, a);\n", "")
    text = _edit(text, "      if (FOLD && s < steps) dw_put<BM, BN>(smem + s * T::STAGE, py[s], a);\n",
                 "      ;\n")
    text = _edit(text, "    if (FOLD && next) dw_put<BM, BN>(next_slot, yr, a);\n", "")
    text = _edit(text, """    cp_async_wait<DX_STAGES - 2>();   // this thread's copies of step k landed
""", """    cp_async_wait<DX_STAGES - 2>();   // this thread's copies of step k landed
    if (FOLD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = ((tid >> 2) + 64 * h) * DX_P + 4 * (tid & 3);
        float4* gp = reinterpret_cast<float4*>(smem + k % DX_STAGES * DX_STAGE + at);
        *gp = act_grad4(*gp, *reinterpret_cast<const float4*>(
            smem + DX_STAGES * DX_STAGE + k % DX_STAGES * (DX_BM * DX_P) + at), a.act, a.slope);
      }
    }
""")
    text = _edit(text, """    cp_async_wait<DW_STAGES - 2>();   // this thread's copies of stage k landed
""", """    cp_async_wait<DW_STAGES - 2>();   // this thread's copies of stage k landed
    if (FOLD) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        const int at = (tid / 16) * BN + 4 * (tid % 16 + 16 * j);
        float4* gp = reinterpret_cast<float4*>(smem + k % DW_STAGES * T::STAGE + DW_BK * BM + at);
        *gp = act_grad4(*gp, *reinterpret_cast<const float4*>(
            smem + DW_STAGES * T::STAGE + k % DW_STAGES * (DW_BK * BN) + at), a.act, a.slope);
      }
    }
""")
    text = _edit(text, """    auto kernel = act ? dx_kernel<1> : dx_kernel<0>;
""", """    auto kernel = act ? dx_kernel<1> : dx_kernel<0>;
    smem_bytes += act ? 4 * DX_STAGES * DX_BM * DX_P : 0;
""")
    return _edit(text, """  auto kernel = a.act ? dw_kernel<BM, BN, 1> : dw_kernel<BM, BN, 0>;
""", """  auto kernel = a.act ? dw_kernel<BM, BN, 1> : dw_kernel<BM, BN, 0>;
  smem_bytes += a.act ? 4 * DW_STAGES * DW_BK * BN : 0;
""")


def _fold_at_load(src: str) -> str:
    """The rich dx kernel forms g * act'(y) as the loads return and keeps only
    it in registers until the store, in place of keeping g and y."""
    text = _edit(src, """      gr[h] = ld_quad(g + off, n, a.vg);
      yr[h] = ld_quad(y + off, n, a.vg);""", """      gr[h] = act_grad4(ld_quad(g + off, n, a.vg), ld_quad(y + off, n, a.vg), a.act, a.slope);""")
    return _edit(text, "4 * (threadIdx.x & 3)) = act_grad4(gr[h], yr[h], a.act, a.slope);",
                 "4 * (threadIdx.x & 3)) = gr[h];")


def _dw_g_in_registers(src: str) -> str:
    """The rich dw kernel loads g into registers beside y, as dx does (the
    upper half of `yr`), and stores g * act'(y), in place of copying g by
    cp.async and rewriting it in place."""
    text = _edit(src, "void dw_stage(float* xs, float4 (&yr)[BN / 64],",
                 "void dw_stage(float* xs, float4 (&yr)[2 * (BN / 64)],")
    text = _edit(text, """    cp_quad(gs + kk * BN + 4 * (lane16 + 16 * j), g + off, g, n, a.vw);
    if (FOLD) yr[j] = ld_quad(y + off, n, a.vw);""", """    if (FOLD) {
      yr[j] = ld_quad(y + off, n, a.vw);
      yr[BN / 64 + j] = ld_quad(g + off, n, a.vw);
    } else {
      cp_quad(gs + kk * BN + 4 * (lane16 + 16 * j), g + off, g, n, a.vw);
    }""")
    text = _edit(text, "__device__ __forceinline__ void dw_put(float* xs, const float4 (&yr)[BN / 64],",
                 "__device__ __forceinline__ void dw_put(float* xs, const float4 (&yr)[2 * (BN / 64)],")
    text = _edit(text, "  float* gs = xs + DW_BK * BM;\n  cp_async_wait<0>();\n",
                 "  float* gs = xs + DW_BK * BM;\n")
    text = _edit(text, "    *piece = act_grad4(*piece, yr[j], a.act, a.slope);",
                 "    *piece = act_grad4(yr[BN / 64 + j], yr[j], a.act, a.slope);")
    text = _edit(text, "  float4 yr[T::GP];\n", "  float4 yr[2 * T::GP];\n")
    return _edit(text, "    float4 py[DW_STAGES - 1][T::GP];\n", "    float4 py[DW_STAGES - 1][2 * T::GP];\n")


def variants(src: str) -> dict:
    """name: (source text, computes right values)."""
    return {
        "base": (src, True),
        "smem_fold": (_smem_fold(src), True),
        "no_y_load": (_edit(_edit(_edit(src, "      yr[h] = ld_quad(y + off, n, a.vg);",
                                        "      yr[h] = gr[h];"),
                                  "    if (FOLD) yr[j] = ld_quad(y + off, n, a.vw);\n", ""),
                            "    *piece = act_grad4(*piece, yr[j], a.act, a.slope);",
                            "    *piece = act_grad4(*piece, *piece, a.act, a.slope);"),
                      False),
        "ld_pinned": (_edit(src, LD_QUAD, LD_QUAD_PINNED), True),
        "fold_at_load": (_fold_at_load(src), True),
        "dw_g_in_registers": (_dw_g_in_registers(src), True),
        "rich_act_once": (_edit(src, ACT4_PER_CHANNEL, ACT4_ONCE), True),
        "dw_one_block_an_sm": (_edit(src, "__launch_bounds__(DW_THREADS, 2)\ndw_kernel(",
                                     "__launch_bounds__(DW_THREADS)\ndw_kernel("), True),
        "dx_poor_fold_every_lane": (_edit(src, DX_POOR_SHARED, DX_POOR_EVERY_LANE), True),
        "dx_poor_act_per_pixel": (_edit(_edit(_edit(src, DX_POOR_SHARED, DX_POOR_EVERY_LANE),
                                              DX_POOR_PIXEL, DX_POOR_PIXEL_RUN_TIME),
                                        DX_POOR_SWITCH,
                                        "  dx_poor_walk<R, 0>(g, y, smem, gwin, a, b, i, j0, cq, "
                                        "acc);\n"),
                                  True),
        "dx_poor_shfl": (_edit(_edit(src, DX_POOR_SHARED, DX_POOR_EVERY_LANE),
                               DX_POOR_PIXEL, DX_POOR_SHFL), True),
        "dw_poor_every_lane": (_edit(src, DW_POOR_SHFL, DW_POOR_EVERY_LANE), True),
    }


def main() -> int:
    root = os.getcwd()
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels.transpose_conv2d import transpose_conv2d_fused
    from repro_torch.models import gan

    if not torch.cuda.is_available():
        print("fold_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    src = (_build.CSRC / "transpose_conv2d_bwd.cu").read_text()
    vs = variants(src)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, (text, _)) in enumerate(vs.items()):
        path = os.path.join(OUT, f"fold{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), path[:-3] + ".so")
    registers = {}
    for name, (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        registers[name] = {
            m.group(0): [rep["registers"], rep["spill_stores"]]
            for fn, rep in _build.ptxas_report(log).items()
            for m in [re.search(r"d[xw]_(poor_)?kernel(I(Li\d+E)+)?", fn)] if m}
        print(f"[registers, spill bytes] {name}: {registers[name]}", flush=True)

    real = bw._lib()
    fns = ("tconv_dx_f32", "tconv_dw_f32", "tconv_sum_splits_f32", "tconv_epilogue_grad_f32")

    def bind(name):
        lib = ctypes.CDLL(procs[name][1])
        for f in fns:
            getattr(lib, f).argtypes = getattr(real, f).argtypes
            getattr(lib, f).restype = ctypes.c_int
        bw._lib = lambda: lib

    inputs = []
    for i, shape in enumerate(LAYERS):
        x, k, bias, g = cs._bwd_inputs(torch, shape, seed=300 + i)
        epi = gan.generator_epilogues(gan.DCGAN)[i]
        bind("base")
        y = transpose_conv2d_fused(x, k, shape[3], epilogue=epi, bias=bias)
        gm = bw.epilogue_grad(g, y, epi)
        want = (bw.transpose_conv2d_dx(gm, k, shape[1], shape[3]),
                *bw.transpose_conv2d_dw(x, gm, shape[2], shape[3], with_db=True))
        inputs.append((shape, epi, x, k, g, y, gm, want))

    results = {name: [] for name in vs}
    for turn in range(2):
        for name, (_, exact) in vs.items():
            bind(name)
            rows = []
            for shape, epi, x, k, g, y, gm, want in inputs:
                n_in, n_k, pad = shape[1], shape[2], shape[3]
                fold = dict(y=y, epilogue=epi)
                if exact:
                    got = (bw.transpose_conv2d_dx(g, k, n_in, pad, **fold),
                           *bw.transpose_conv2d_dw(x, g, n_k, pad, with_db=True, **fold))
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise SystemExit(f"{name} is not bitwise the three-kernel route "
                                         f"at {shape}")
                rows.append({
                    "shape": shape, "act": epi.act,
                    "dx_folded": cs._device_us(torch, bw.transpose_conv2d_dx, g, k, n_in,
                                               pad, **fold),
                    "dw_folded": cs._device_us(torch, bw.transpose_conv2d_dw, x, g, n_k,
                                               pad, with_db=True, **fold),
                    "dx_gm": cs._device_us(torch, bw.transpose_conv2d_dx, gm, k, n_in, pad),
                    "dw_gm": cs._device_us(torch, bw.transpose_conv2d_dw, x, gm, n_k, pad,
                                           with_db=True),
                    "epilogue_grad": cs._device_us(torch, bw.epilogue_grad, g, y, epi)})
            results[name].append(rows)
            print(f"[us] {name} (turn {turn}): " + " | ".join(
                f"L{i} dx {r['dx_folded']:.2f} (gm {r['dx_gm']:.2f}) dw {r['dw_folded']:.2f} "
                f"(gm {r['dw_gm']:.2f}) epi {r['epilogue_grad']:.2f}"
                for i, r in enumerate(rows)), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "fold_ablation.json"), "w") as f:
        json.dump({"device": smi, "registers": registers, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
