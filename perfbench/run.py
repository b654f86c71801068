"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The program under test is the PyTorch and CUDA port ``repro_torch``; the
run needs a CUDA card and never falls back to the CPU.  A run makes the
cell's corpus and query stream from ``--seed``, loads the corpus into
the program through its own API, warms the cell's own shapes, drives the
cell's closed-loop clients for ``--seconds``, and then holds the rows the
window returned to the plain reference.  ``--trace 1`` runs the window
under ``torch.profiler`` and reports the cell's per-layer metrics in
place of its end-to-end ones; where the trace lost records of the window
(``harness/trace.py``, ``verify``) it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

import numpy as np  # noqa: E402

from harness import check, spec, traffic, window  # noqa: E402
from harness import corpus as C  # noqa: E402
from harness import reference as R  # noqa: E402
from harness.system import System  # noqa: E402
from harness.trace import IncompleteTrace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def shapes(system: System, mix, first_tokens: str, live_rows: int):
    """The kernels' shapes a request of this mix gives: the rows' width and
    K3's pool."""
    q = R.parse(first_tokens)
    k = check.plan_k(q, live_rows)
    width = check.pool_width(q, k, live_rows)
    return {"d": int(system.config["dim"]),
            "mmr": ({"live": width, "k": k, "bucket": width}
                    if q.diverse else None)}


def _sync(torch, device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Built(types.SimpleNamespace):
    """A configuration made from a seed: ``config``, ``corpus``, ``live``
    and the program loaded with it, ``system``."""


def build(root: Path, bench, config_name: str, seed: int, device: str,
          sizes=None) -> Built:
    """Make the corpus from ``seed`` and load it into the program;
    ``sizes`` overrides configuration keys (the CPU tests' tiny corpus)."""
    config = dict(spec.config(root, bench, config_name), **(sizes or {}))
    n = int(config["chunks"])
    corpus = C.generate(n, int(config["sessions"]), float(config["days"]),
                        seed, float(config["now"]), int(config["dim"]))
    live = C.tombstones(n, float(config["tombstoned"]), seed)
    return Built(config=config, corpus=corpus, live=live,
                 system=System(config, corpus, live, device))


def drive(built: Built, mix, seed: int, seconds: float, trace: bool,
          device: str, on_warm=None) -> types.SimpleNamespace:
    """Warm the mix's shapes, then its clients for ``seconds``."""
    import torch

    system = built.system
    call = system.entry(mix)
    clients = int(mix["clients"])
    stream = traffic.QueryStream(mix, seed)
    warm = traffic.QueryStream(mix, seed, traffic.WARMUP)
    window.run(call, warm.request, clients, float("inf"),
               limit=int(mix["warmup"]) * clients)
    _sync(torch, device)
    before = system.counters()
    if on_warm is not None:
        on_warm()
    tracer = None
    if trace:
        from harness.trace import Tracer

        tracer = Tracer()
        with tracer:
            with tracer.window():
                records, w0, w1 = window.run(call, stream.request, clients,
                                             seconds)
                _sync(torch, device)
    else:
        records, w0, w1 = window.run(call, stream.request, clients, seconds)
        _sync(torch, device)
    after = system.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    return types.SimpleNamespace(
        records=records, start=w0, end=w1, stream=stream, delta=delta,
        summary=tracer.read(records, delta) if tracer is not None else None)


def judge(built: Built, mix, seed: int, run) -> dict:
    """The compared numbers of a window's rows, each with its limit: the
    exact counts over every request, the reference's comparison over the
    seed's sample."""
    records = run.records
    requests = [run.stream.request(r.index) for r in records]
    numbers = check.exact_counts(mix, records, requests, built.live)
    limits = {k: 0 for k in numbers}
    ref = R.Reference(built.corpus.matrix, built.corpus.timestamps,
                      built.live, float(built.config["now"]))
    picked = check.sample(records, seed, int(mix["check"]["sample"]))
    numbers.update(check.compare(ref, mix, [requests[i] for i in picked],
                                 [records[i].rows for i in picked]))
    limits.update(mix["check"]["limits"])
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits} if picked else {}


def run_cell(root: Path, bench, cell, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, sizes=None):
    """One run of ``cell``: its result line as a dict."""
    import torch

    built = build(root, bench, cell["config"], seed, device, sizes)
    mix = spec.traffic(root, cell["traffic"])
    setup = {}
    run = drive(built, mix, seed, seconds, trace, device,
                on_warm=lambda: setup.update(s=time.perf_counter() - t_start))
    cuda = device.startswith("cuda")
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count())) if cuda else 0)
    answered = [r for r in run.records if r.error is None]
    lat = np.asarray([(r.end - r.start) * 1e3 for r in answered])
    e2e = {"setup_s": setup["s"],
           "query_p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
           "query_p95_ms": float(np.percentile(lat, 95)) if lat.size else None}
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(
            trace=run.summary, completed=len(answered), delta=run.delta,
            shapes=shapes(built.system, mix, run.stream.tokens(0),
                          int(built.live.sum())))
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.metric_module(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(bench, cell["name"]):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    # the program's state goes before the reference runs
    built.system.release()
    gc.collect()
    checks = judge(built, mix, seed, run)
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(run.records),
           "failed": len(run.records) - len(answered), "metrics": metrics,
           "device": dev}
    if run.summary is not None:
        dev["busy_s"] = run.summary["busy_s"]
        dev["window_s"] = run.summary["window_s"]
        out["breakdown"] = run.summary["breakdown"]
        out["trace"] = run.summary["verified"]
    out["counters"] = run.delta
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              "none or too few found", file=sys.stderr)
        return 2
    try:
        out = run_cell(ROOT, bench, cell, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START)
    except IncompleteTrace as e:
        print(f"{args.workload}: the trace is incomplete, no reading taken: "
              f"{e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, reading in out.get("trace", {}).items():
        print(f"trace {name} {json.dumps(reading)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
