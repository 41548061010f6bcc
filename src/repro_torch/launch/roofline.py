"""The card's data-sheet peaks and the three-term roofline. Mirrors
``repro/launch/roofline.py``.

Hardware model: one NVIDIA H100 SXM (:data:`CARD`), dense rates without
sparsity, at the full power limit. A card set below 700 W runs slower under
load, so every measurement beside these figures names the card's power
limit. This module is the one home of the peaks: ``chip_smoke.py`` and
``kernels/autotune.py`` import them.

    compute    = FLOPs_per_card   / PEAK_FLOPS
    memory     = bytes_per_card   / HBM_BW
    collective = coll_bytes_card  / LINK_BW

The reference derives the report's numbers from a compiled XLA module (its
cost analysis, memory analysis and the collectives in its HLO text). The
port counts them from a traced call's dispatched ops
(:mod:`repro_torch.launch.op_analysis`, per rank, in the dry run
:mod:`repro_torch.launch.dryrun`); :func:`roofline_report` takes the same
report dict, however its numbers were counted.
"""
from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12   # dense bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
NVLINK_BW = 900e9          # bytes/s, the data sheet's "NVLink: 900GB/s"
PEAK_FLOPS = PEAK_BF16_FLOPS   # the roofline's compute peak, bf16 as the reference's
LINK_BW = NVLINK_BW


def model_flops(cfg, shape) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference) useful-FLOP floor."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n * tokens


def roofline_report(report: dict, cfg, shape) -> dict:
    """Three-term roofline of one step. ``report`` holds ``chips`` (the
    cards the step runs on), per-card ``flops`` and ``bytes_accessed``,
    ``collectives["total"]`` (wire bytes a card) and ``memory`` (argument,
    output and temporary bytes). The memory term is bracketed:

    memory_lb -- fusion-perfect traffic (arguments read + outputs written +
        temporaries written and read once).
    memory_ub -- op-level bytes accessed: every op's operands and result,
        nothing resident. Dominance and the roofline fraction use the lb.
    """
    chips = report["chips"]
    flops = report.get("flops") or 0.0
    byts = report.get("bytes_accessed") or 0.0
    coll = report.get("collectives", {}).get("total", 0)
    mem = report.get("memory", {})
    mem_lb_bytes = (
        mem.get("argument_size_in_bytes", 0)
        + mem.get("output_size_in_bytes", 0)
        + 2 * mem.get("temp_size_in_bytes", 0)
    )
    compute_t = flops / PEAK_FLOPS
    memory_lb_t = mem_lb_bytes / HBM_BW
    memory_ub_t = byts / HBM_BW
    coll_t = coll / LINK_BW
    terms = {"compute_s": compute_t, "memory_s": memory_lb_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / chips
    step_t = max(terms.values())
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "memory_ub_s": float(f"{memory_ub_t:.6g}"),
        "dominant": dominant,
        "model_flops_per_chip": float(f"{mf:.6g}"),
        "useful_flop_ratio": float(f"{mf / flops:.4g}") if flops else None,
        "roofline_fraction": float(
            f"{(mf / PEAK_FLOPS) / step_t:.4g}"
        ) if step_t else None,
        "step_time_lower_bound_s": float(f"{step_t:.6g}"),
    }
