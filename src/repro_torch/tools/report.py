"""Render the dry-run JSON files into tables.

Counterpart of ``repro/tools/report.py``: given the same JSON, the same
text.  A cell that stopped (its JSON holds ``error``, which the reference's
tables have no row for) is a FAIL row with the error.

    PYTHONPATH=src python -m repro_torch.tools.report \
        [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import pathlib


def load_cells(d: pathlib.Path) -> list[dict]:
    cells = []
    for f in sorted(d.glob("*.json")):
        cells.append(json.loads(f.read_text()))
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(cells: list[dict], mesh: str = "16x16") -> str:
    rows = [
        "| cell | mode | compute | memory | collective | dominant | "
        "useful FLOPs | MFU@bound |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if "skipped" in c:
            rows.append(
                f"| {c['cell']} | — | — | — | — | — | — | {c['skipped']} |"
            )
            continue
        if "error" in c:
            rows.append(f"| {c['cell']} | — | — | — | — | — | — | FAIL |")
            continue
        t = c["terms_seconds"]
        rows.append(
            f"| {c['arch']} × {c['shape']} | {c['mode']} "
            f"| {fmt_s(t['compute'])} | {fmt_s(t['memory'])} "
            f"| {fmt_s(t['collective'])} | **{c['dominant']}** "
            f"| {c['useful_flops_ratio']*100:.0f}% "
            f"| {c['mfu_at_bound']*100:.1f}% |"
        )
    return "\n".join(rows)


def dryrun_table(cells: list[dict]) -> str:
    rows = [
        "| cell | mesh | status | compile (s) | per-dev FLOPs | "
        "per-dev bytes | collective bytes | arg GB (global) | temp GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if "skipped" in c:
            rows.append(
                f"| {c['cell']} | {c.get('mesh','')} | SKIP: {c['skipped']}"
                " | | | | | | |"
            )
            continue
        if "error" in c:
            rows.append(f"| {c['cell']} | {c.get('mesh','')} | FAIL: "
                        f"{c['error']} | | | | | | |")
            continue
        ma = c.get("memory_analysis") or {}
        rows.append(
            f"| {c['arch']} × {c['shape']} | {c['mesh']} | OK "
            f"| {c['compile_seconds']} "
            f"| {c['flops_per_device']:.2e} | {c['bytes_per_device']:.2e} "
            f"| {c['collectives']['total_bytes']:.2e} "
            f"| {ma.get('argument_size_in_bytes', 0)/2**30:.0f} "
            f"| {ma.get('temp_size_in_bytes', 0)/2**30:.0f} |"
        )
    return "\n".join(rows)


def summary(cells: list[dict]) -> dict:
    ok = [c for c in cells if "terms_seconds" in c]
    skip = [c for c in cells if "skipped" in c]
    failed = [c["cell"] for c in cells if "error" in c]
    worst = sorted(
        (c for c in ok if c["mesh"] == "16x16"),
        key=lambda c: c["mfu_at_bound"],
    )
    most_coll = sorted(
        (c for c in ok if c["mesh"] == "16x16"),
        key=lambda c: -c["terms_seconds"]["collective"],
    )
    out = {
        "n_ok": len(ok), "n_skip": len(skip),
        "worst_mfu": [c["cell"] for c in worst[:5]],
        "most_collective": [c["cell"] for c in most_coll[:5]],
    }
    if failed:
        out["failed"] = failed
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    cells = load_cells(pathlib.Path(args.dir))
    print("## Dry-run\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(cells, args.mesh))
    print("\n## Summary\n")
    print(json.dumps(summary(cells), indent=2))


if __name__ == "__main__":
    main()
