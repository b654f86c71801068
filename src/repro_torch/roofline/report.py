"""Render the port's dry-run JSONs into the three tables of the reference.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir reports/dryrun/torch]

The port of ``repro.roofline.report``.  Emits: the dry-run summary (per
cell x mesh: the meta run's time, per-device memory, collective bytes),
the roofline (single-pod three-term table at the H100's figures) and the
collective mix.  The "compile" column is the counterpart of XLA's
compile: ``spec.fn`` run on the meta device (``launch/dryrun.py``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional


def load_cells(report_dir: Path, rules: str = "default") -> List[Dict]:
    cells = []
    for p in sorted(report_dir.glob("*.json")):
        d = json.loads(p.read_text())
        if "error" in d:
            continue
        if d.get("rules", "default") != rules:
            continue
        cells.append(d)
    return cells


def _fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_b(x: Optional[float]) -> str:
    if not x:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def dryrun_table(cells: List[Dict]) -> str:
    out = ["| arch | shape | mesh | meta run | FLOPs | bytes | coll. bytes | arg/dev | temp/dev | note |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in sorted(cells, key=lambda d: (d["arch"], d["shape"], d["mesh"])):
        mem = d.get("per_device_memory") or {}
        note = ""
        if d.get("skip_reason"):
            note = "skip-noted; run beyond-assignment"
        elif d.get("beyond_assignment"):
            note = "beyond-assignment"
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            f"ok ({d.get('compile_s', 0):.3g}s) | "
            f"{d['hlo_flops']:.3g} | {_fmt_b(d['hlo_bytes'])} | "
            f"{_fmt_b(d['collective_bytes'])} | "
            f"{_fmt_b(mem.get('argument_size_in_bytes'))} | "
            f"{_fmt_b(mem.get('temp_size_in_bytes'))} | {note} |"
        )
    return "\n".join(out)


def roofline_table(cells: List[Dict]) -> str:
    out = ["| arch | shape | t_compute | t_memory | t_collective | bottleneck | MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in sorted(cells, key=lambda d: (d["arch"], d["shape"])):
        if d["mesh"] != "16x16":
            continue
        ur = d.get("useful_flops_ratio")
        out.append(
            f"| {d['arch']} | {d['shape']} | {_fmt_s(d['t_compute_s'])} | "
            f"{_fmt_s(d['t_memory_s'])} | {_fmt_s(d['t_collective_s'])} | "
            f"**{d['bottleneck']}** | "
            f"{(d.get('model_flops') or 0):.3g} | "
            f"{ur:.3f} | {d['roofline_fraction']:.4f} |"
            if ur is not None else
            f"| {d['arch']} | {d['shape']} | - | - | - | - | - | - | - |"
        )
    return "\n".join(out)


def collective_mix_table(cells: List[Dict]) -> str:
    out = ["| arch | shape | mesh | all-gather | all-reduce | reduce-scatter | all-to-all | collective-permute |",
           "|---|---|---|---|---|---|---|---|"]
    for d in sorted(cells, key=lambda d: (d["arch"], d["shape"], d["mesh"])):
        ops = d.get("collective_by_op") or {}
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
            + " | ".join(_fmt_b(ops.get(k)) for k in
                         ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute")) + " |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun/torch")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--out", default="reports/roofline_report_torch.md")
    args = ap.parse_args()
    cells = load_cells(Path(args.dir), args.rules)
    single = [c for c in cells if c["mesh"] == "16x16"]
    multi = [c for c in cells if c["mesh"] == "2x16x16"]
    text = "\n\n".join([
        f"## Dry-run summary ({len(cells)} cells run: "
        f"{len(single)} single-pod, {len(multi)} multi-pod)",
        dryrun_table(cells),
        "## Roofline (single-pod 16x16, 256 H100s)",
        roofline_table(cells),
        "## Collective mix",
        collective_mix_table(cells),
    ])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(f"wrote {args.out}: {len(cells)} cells")


if __name__ == "__main__":
    main()
