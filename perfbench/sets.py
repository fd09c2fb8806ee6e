"""Measure a cell's run-to-run spread: sets of runs, each a new process.

    python3 perfbench/sets.py --workload <cell> --seeds 1 2 3 4 5 6 \
        [--sets 2] [--traced 7 8 9] [--seconds S] [--out FILE]

Runs ``perfbench/run.py`` once per seed in each set (the same seeds in
every set, in order), then once with ``--trace 1`` per ``--traced``
seed.  Every result line is appended to ``--out`` with its seed, set and
wall seconds.  At the end it prints, for each end-to-end metric and set,
the median and the spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median, and the bound the contract's rule gives (five times the wider
spread, never under 1%).  Not run by the benchmark's own runs.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    runs = [(s, k, 0) for k in range(args.sets) for s in args.seeds] + \
        [(s, "traced", 1) for s in args.traced]
    by_set: dict = {}
    for seed, set_id, trace in runs:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace",
             str(trace)], cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        row = {"workload": args.workload, "seed": seed, "set": set_id,
               "trace": trace, "rc": proc.returncode, "wall_s": wall,
               "stderr_tail": proc.stderr[-600:]}
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["result"] = None
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row["result"] or {}
        print(f"{args.workload} set {set_id} seed {seed} rc {proc.returncode}"
              f" wall {wall:.1f} s correct {res.get('correct')} "
              f"{json.dumps({k: v['value'] for k, v in res.get('metrics', {}).items()})}"
              f" {json.dumps(res.get('checks'))}", flush=True)
        if trace == 0 and res:
            for name, m in res["metrics"].items():
                by_set.setdefault(name, {}).setdefault(set_id, []).append(
                    m["value"])
    for name, sets in by_set.items():
        spreads = {k: spread(v) for k, v in sets.items() if len(v) >= 2}
        medians = {k: statistics.median(v) for k, v in sets.items()}
        widest = max(spreads.values()) if spreads else float("nan")
        print(f"{name}: medians {medians} spreads {spreads} "
              f"bound 5x widest {max(5 * widest, 0.01):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
