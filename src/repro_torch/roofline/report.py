"""Render the dry run's two tables from its records (the reference's
``roofline/report.py``, for the one mesh ``h100``: one card).

Usage:  python -m repro_torch.roofline.report [--dir experiments/dryrun] [--one-table]

``--one-table`` prints both tables' columns in one row a cell (what
``PERF.md`` keeps).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

MESH = "h100"


def load(out_dir: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        try:
            with open(f) as fh:
                recs.append(json.load(fh))
        except json.JSONDecodeError:
            continue
    return recs


def fmt_bytes(b: float | None) -> str:
    return "-" if b is None else f"{b / 2**30:.2f}"


def _arch_shape(r: dict) -> tuple[str, str]:
    """A record's arch and shape: its own keys, else parsed from the cell
    id ``<arch>_<shape>_h100`` (shapes hold one underscore)."""
    if "arch" in r and "shape" in r:
        return r["arch"], r["shape"]
    parts = r["cell"][: -len(MESH) - 1].split("_")
    return "_".join(parts[:-2]), "_".join(parts[-2:])


def _on_mesh(r: dict) -> bool:
    return r["cell"].endswith("_" + MESH)


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | status | batch run / global | microbatches | resident GiB | estimate GiB | "
        "peak GiB | fits card | step s (median) | tokens/s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not _on_mesh(r):
            continue
        arch, shape = _arch_shape(r)
        status = r["status"]
        if status == "skipped":
            lines.append(f"| {arch} | {shape} | skipped: {r['reason']} | | | | | | | | |")
            continue
        if status == "error":
            lines.append(f"| {arch} | {shape} | ERROR {r.get('error', '')[:60]} | | | | | | | | |")
            continue
        m = r["memory"]
        resident = m["resident_bytes"]["total"]
        if status == "does_not_fit":
            lines.append(
                f"| {arch} | {shape} | does not fit | 0 / {r['global_batch']} | | {fmt_bytes(resident)} | "
                f"{fmt_bytes(m['estimate_bytes'])} | | False (budget {fmt_bytes(m['budget_bytes'])}) | | |"
            )
            continue
        lines.append(
            f"| {arch} | {shape} | ok | {r['batch']} / {r['global_batch']} | {r['microbatches']} | "
            f"{fmt_bytes(resident)} | {fmt_bytes(m['estimate_bytes'])} | {fmt_bytes(m['peak_bytes'])} | "
            f"{m['fits_card']} | {r['step_s']['median']:.4g} | {r['tokens_per_s']:.4g} |"
        )
    return "\n".join(lines)


def top_op(r: dict) -> str:
    """The aten op (and its output type) that moved the most bytes in a
    record's counted step, with its share of the counted bytes."""
    c = r["counts"]
    if not c.get("top_ops_by_bytes"):
        return "-"
    op, moved, calls = c["top_ops_by_bytes"][0]
    return f"{op} x{calls} ({moved / (c['aten_bytes'] + c['kernel_bytes']):.2f})"


def roofline_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | bottleneck | floor s | MODEL_FLOPs | useful frac | roofline frac | "
        "measured step s | floor frac | mfu | top op by bytes (share) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok" or not _on_mesh(r):
            continue
        arch, shape = _arch_shape(r)
        rl = r["roofline"]
        lines.append(
            f"| {arch} | {shape} | {rl['compute_s']:.4g} | {rl['memory_s']:.4g} | **{rl['bottleneck']}** | "
            f"{rl['floor_s']:.4g} | {rl['model_flops']:.3g} | {rl['useful_flops_fraction']:.3f} | "
            f"{rl['roofline_fraction']:.4f} | {rl['measured_step_s']:.4g} | {rl['floor_fraction']:.4g} | "
            f"{rl['mfu']:.4f} | {top_op(r)} |"
        )
    return "\n".join(lines)


def one_table(recs: list[dict]) -> str:
    """Every cell in one row: batch, memory, speed and roofline columns."""
    lines = [
        "| arch | shape | batch run / global | resident + estimate GiB | peak GiB | step s | tokens/s | "
        "compute s | memory s | floor s | bottleneck | roofline frac | mfu |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not _on_mesh(r):
            continue
        arch, shape = _arch_shape(r)
        if r["status"] in ("skipped", "error"):
            what = r.get("reason") or r.get("error", "")[:60]
            lines.append(f"| {arch} | {shape} | {r['status']}: {what} | | | | | | | | | | |")
            continue
        m = r["memory"]
        need = f"{fmt_bytes(m['resident_bytes']['total'])} + {fmt_bytes(m['estimate_bytes'])}"
        if r["status"] == "does_not_fit":
            why = "out of memory at batch 1" if m.get("why") == "out of memory at batch 1" else f"> {fmt_bytes(m['budget_bytes'])}"
            lines.append(f"| {arch} | {shape} | does not fit (0 / {r['global_batch']}) | {need} {why} | | | | | | | | | |")
            continue
        rl = r["roofline"]
        lines.append(
            f"| {arch} | {shape} | {r['batch']} / {r['global_batch']} | {need} | {fmt_bytes(m['peak_bytes'])} | "
            f"{r['step_s']['median']:.4g} | {r['tokens_per_s']:.4g} | {rl['compute_s']:.4g} | "
            f"{rl['memory_s']:.4g} | {rl['floor_s']:.4g} | {rl['bottleneck']} | {rl['roofline_fraction']:.4f} | "
            f"{rl['mfu']:.4f} |"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("experiments", "dryrun"))
    ap.add_argument("--one-table", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    cards = sorted({r["card"] for r in recs if r.get("card")})
    print(f"\n### Dry run — {MESH} ({'; '.join(cards) or 'no card recorded'})\n")
    if args.one_table:
        print(one_table(recs))
        return
    print(dryrun_table(recs))
    print(f"\n### Roofline — {MESH}\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
