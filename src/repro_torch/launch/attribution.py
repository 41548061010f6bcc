"""Collective attribution: ranks every collective of a traced cell by wire
bytes times repeats, each with the function of this package that issued
it. Mirrors ``repro/launch/attribution.py``, where the provenance is the
HLO ``op_name`` of a compiled module; here it is the innermost frame of
``repro_torch`` on the stack when the collective was dispatched
(:class:`repro_torch.launch.op_analysis.OpCounter`), and a repeat is a
call of the same kind, type and site (a layer's, a chunk's), where the
reference multiplies by its ``while`` trip counts.

Usage (no card needed; a fake world in this one process)::

  PYTHONPATH=src python -m repro_torch.launch.attribution --arch llama3-8b \\
      --shape decode_32k [--multi-pod] [--top 15]
"""
from __future__ import annotations

import argparse


def collective_items(counter) -> list:
    """``[(wire bytes x repeats, kind, type, repeats, site), ...]``, largest
    first, from an :class:`~repro_torch.launch.op_analysis.OpCounter` that
    watched a call."""
    return counter.collective_items()


def report(counter, top: int = 15) -> str:
    """The reference's table: the total wire bytes a rank, then the
    ``top`` sites."""
    items = collective_items(counter)
    total = sum(i[0] for i in items)
    lines = [f"total collective wire bytes/rank: {total / 1e9:.2f} GB "
             f"({len(items)} sites)"]
    for b, op, shape, mult, name in items[:top]:
        lines.append(f"{b / 1e9:9.2f}GB x{mult:5d} {op:18s} {shape[:50]:50s} {name[-90:]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import compile_cell

    counter, _ = compile_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    print(report(counter, args.top))


if __name__ == "__main__":
    main()
