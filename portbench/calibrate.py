"""Readings that the benchmark's bounds and limits are set from; not run by
the benchmark's own runs.

    python3 portbench/calibrate.py limits --workload W --seeds 1,2,3 --seconds 8
        one process, a short window on each seed: the program's compared
        numbers and the fp8 control's (the reference computed with every
        product's operands rounded to float8 e4m3) on the same requests,
        and the verdict the cell's limits give each (``correct``,
        ``control_fp8_correct``);
    python3 portbench/calibrate.py knee --workload W --rates 4,5,6 --seconds 20
        the cell's configuration, lengths and server sent as an open loop
        (``loops/poisson.py``) at each rate: completed, failed, the latency
        quartiles and the backlog's trend (latency of the last third of
        the requests over the first third).

One JSON line a seed or rate on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench-calibrate")
    p.add_argument("what", choices=("limits", "knee"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--numbers", default="", help="comma-separated numbers to read (default: the cell's limits')")
    p.add_argument("--control-seeds", type=int, default=1000, help="read the control on the first N seeds")
    args = p.parse_args(argv)

    import torch

    from portbench import harness, readers

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    if args.what == "limits":
        numbers = [n for n in args.numbers.split(",") if n] or None
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            controls = ("fp8",) if i < args.control_seeds else ()
            out = harness.run_cell(args.workload, seed, args.seconds, False, ROOT, controls=controls,
                                   numbers=numbers)
            line = out["line"]
            print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in line["checks"].items()},
                              "correct": line["correct"], "control_fp8": out["control"].get("fp8"),
                              "control_fp8_correct": out["control_correct"].get("fp8"),
                              "attempted": line["attempted"],
                              "failed": line["failed"], "metrics": line["metrics"]}), flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            out = harness.run_cell(args.workload, seeds[i % len(seeds)], args.seconds, False, ROOT,
                                   mix_override=lambda m: {**m, "loop": "poisson", "rate_per_s": rate},
                                   limits_override=lambda l: {**l, "sample": 1})
            run = out["run"]
            lat = readers.latencies(run)
            third = max(1, len(lat) // 3)
            done = [x for x in lat if x != float("inf")]
            print(json.dumps({"rate_per_s": rate, "attempted": len(lat), "failed": out["line"]["failed"],
                              "sheds": run.server_counts.get("sheds"),
                              "p50": readers.percentile(done, 50) if done else None,
                              "p95": readers.percentile(done, 95) if done else None,
                              "first_third_mean": sum(lat[:third]) / third,
                              "last_third_mean": sum(lat[-third:]) / third,
                              "batch_mean": readers.batch_mean(run),
                              "lateness_s": getattr(run, "lateness_s", None)}), flush=True)
            del out, run
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
