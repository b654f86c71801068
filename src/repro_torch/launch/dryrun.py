"""Multi-pod dry run: every cell laid out over the production meshes, its
step run on the meta device, its roofline counted.  No device needed.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell with XLA over 512 placeholder devices, the port builds
the cell's ``LoweredSpec`` over an abstract 16x16 or 2x16x16 mesh and runs
``spec.fn`` on meta tensors of the shapes one device takes: every kernel
wrapper checks its inputs as it does on the card and returns its outputs'
shapes, launching nothing, so a shape error fails the cell as a failed
compile does there.  Flops and bytes are the architecture's own count of
each kernel's work on one device (``ArchSpec.step_cost``, the count
``chip_smoke.py`` also reads for its bounds), scaled to the fleet at the
H100's figures (``roofline/analysis.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch flexvec --shape corpus_1m
    python -m repro_torch.launch.dryrun --arch flexvec --shape corpus_67m --multi-pod
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all      # every cell, both meshes

A single cell prints its report (and writes it to ``--out`` when given);
``--all`` writes reports/dryrun/torch/<arch>__<shape>__<mesh>.json for
each cell and skips cells whose JSON exists.  Render the tables with
``python -m repro_torch.roofline.report``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun" / "torch"


def _meta_run(spec, rules):
    """Run the step on meta tensors of one device's shapes; its outputs
    and the seconds it took (the counterpart of the compile time)."""
    t0 = time.perf_counter()
    out = spec.fn(*spec.call_args(rules))
    seconds = time.perf_counter() - t0
    outs = out if isinstance(out, tuple) else (out,)
    if any(o.device.type != "meta" for o in outs):
        raise RuntimeError(f"{spec.static_desc}: an output left the meta "
                           f"device")
    return outs, seconds


def run_cell(arch_id: str, shape: str, multi_pod: bool,
             rules_name: str = "default", arch_obj=None) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.dist.tuned import get_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import HW, analyze

    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.axis_sizes)
    chips = mesh.size
    rules = get_rules(rules_name, mesh)
    arch = arch_obj if arch_obj is not None else get_arch(arch_id)
    cell = arch.cells()[shape]

    t0 = time.perf_counter()
    spec = arch.build(shape, mesh, rules)
    t_lower = time.perf_counter() - t0
    outs, t_compile = _meta_run(spec, rules)

    cost = arch.step_cost(shape, rules)
    mem_stats = {
        "argument_size_in_bytes": float(sum(
            math.prod(rules.block_shape(a.shape, a.spec)) * a.element_size()
            for a in spec.args)),
        "output_size_in_bytes": float(sum(o.numel() * o.element_size()
                                          for o in outs)),
        "temp_size_in_bytes": float(cost.temp_bytes),
    }
    rep = analyze(
        arch_id, shape, mesh_name, chips, cost.flops, cost.nbytes,
        cost.collective_bytes, cost.collectives,
        model_flops=arch.model_flops(shape), memory_stats=mem_stats,
    )
    out = rep.to_dict()
    ef, eb = arch.cost_corrections(shape, chips)
    out.update({
        "rules": rules_name,
        "skip_reason": cell.skip_reason,
        "beyond_assignment": cell.beyond_assignment,
        "lower_s": t_lower,     # build
        "compile_s": t_compile,  # the meta run
        "outputs": [list(o.shape) for o in outs],
        # one device's count, kernel by kernel, and its least time on one
        # H100 (bytes over HBM or operations over their peak)
        "kernels": {name: {"flops": w.flops, "bytes": w.nbytes,
                           "bound_s": HW.bound_s(w),
                           "bound_by": HW.bound_by(w)}
                    for name, w in cost.kernels.items()},
        # the reference's loop correction (its XLA count sees one MMR
        # step); the port's count already holds every step, so it is
        # reported beside the count, not added to it
        "cost_corrections": {"flops": ef, "bytes": eb},
    })
    return out


def cell_list():
    """(arch, shape) of every cell to run, by the reference's rule: the
    assigned cells of each assigned architecture first, then those beyond
    the assignment (flexvec's, and a cell skipped per assignment that is
    run beyond it, as the LM archs' long_500k decode)."""
    from repro_torch.configs import ASSIGNED, get_arch

    assigned, beyond = [], []
    for aid in ASSIGNED + ["flexvec"]:
        for shape, cell in get_arch(aid).cells().items():
            if cell.beyond_assignment or cell.skip_reason or aid == "flexvec":
                if not cell.skip_reason or cell.beyond_assignment:
                    beyond.append((aid, shape))
                continue
            assigned.append((aid, shape))
    return assigned + beyond


def drive_all(rules_name: str = "default",
              report_dir: Path = REPORT_DIR) -> None:
    """Every cell on both meshes, one JSON each (a failed cell's holds its
    error); cells whose JSON exists are skipped."""
    report_dir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True]
    suffix = "" if rules_name == "default" else f"__{rules_name}"
    todo = [(aid, shape, mp, report_dir / (
        f"{aid}__{shape}__{'2x16x16' if mp else '16x16'}{suffix}.json"))
        for aid, shape in cell_list() for mp in meshes]
    todo = [t for t in todo if not t[3].exists()]
    print(f"[dryrun] {len(todo)} cells to run", flush=True)
    for i, (aid, shape, mp, path) in enumerate(todo):
        mesh_name = "2x16x16" if mp else "16x16"
        print(f"[dryrun {i+1}/{len(todo)}] {aid}/{shape} mesh={mesh_name}",
              flush=True)
        try:
            out = run_cell(aid, shape, mp, rules_name)
        except Exception:  # the sweep goes on; the cell's JSON holds why
            out = {"arch": aid, "shape": shape, "mesh": mesh_name,
                   "rules": rules_name, "error": traceback.format_exc()}
            print(f"  FAILED: {out['error'].splitlines()[-1]}", flush=True)
        path.write_text(json.dumps(out, indent=2, default=str))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--out")
    args = ap.parse_args()

    if args.all:
        drive_all(rules_name=args.rules)
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")
    out = run_cell(args.arch, args.shape, args.multi_pod, args.rules)
    text = json.dumps(out, indent=2, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
