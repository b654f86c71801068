"""The readings the limits of ``correct`` are set from, for the cells of
one configuration, seed by seed in one process: the program's numbers
after a short window of each cell's own traffic (what a run compares),
and the control's on the same sampled requests.

The control is the reference put in the program's place at the next
precision below the configuration's float32: every product in TF32
(operands rounded to 10 mantissa bits, float32 sums).  Its answers are
held to the float64 reference by the same comparison as the program's.

    python3 perfbench/control.py --config corpus_240k \\
        --traffic sql_composed --seeds 11,12,13 --seconds 3

The mixes share the program between them in the order given.  One JSON
line a seed and mix.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as bench_run  # noqa: E402
from harness import check, spec  # noqa: E402
from harness import reference as R  # noqa: E402


def control_numbers(built, mix, seed: int, run) -> dict:
    """The control's numbers on the run's sampled requests."""
    picked = check.sample(run.records, seed, int(mix["check"]["sample"]))
    requests = [run.stream.request(run.records[i].index) for i in picked]
    args = (built.corpus.matrix, built.corpus.timestamps, built.live,
            float(built.config["now"]))
    answers = check.produce(R.Reference(*args, precision="tf32"), mix,
                            requests)
    return check.compare(R.Reference(*args), mix, requests, answers)


def readings(root, bench, config: str, mixes, seeds, seconds: float,
             device: str, sizes=None):
    for seed in seeds:
        built = bench_run.build(root, bench, config, seed, device, sizes)
        try:
            for name in mixes:
                mix = spec.traffic(root, name)
                run = bench_run.drive(built, mix, seed, seconds, False, device)
                program = bench_run.judge(built, mix, seed, run)
                yield {"seed": seed, "traffic": name,
                       "requests": len(run.records),
                       "program": {k: c["value"] for k, c in program.items()},
                       "control": control_numbers(built, mix, seed, run)}
        finally:
            built.system.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = spec.load(bench_run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    for line in readings(bench_run.ROOT, bench, args.config,
                         args.traffic.split(","),
                         [int(s) for s in args.seeds.split(",")],
                         args.seconds, "cuda"):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
