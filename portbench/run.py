"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs a CUDA device (as many as the cell's
``chips``) and fails without one: no number here comes from the CPU. The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit. The same numbers end
standard error.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
from pathlib import Path

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    faulthandler.enable()  # a crash leaves the threads' stacks on standard error

    # every build and kernel cache of the run stays at fixed paths in the checkout
    cache = ROOT / "build" / "portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(HERE.parent))

    import torch

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), ROOT, "cuda", chips)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    line = out["line"]
    print(json.dumps({"setup_parts": out["setup"], "reference_s": out["judge_s"],
                      "lateness_s": getattr(out["run"], "lateness_s", None)}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
