"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the card of the machine it is started on.  Exits nonzero, and
prints no result, without enough CUDA cards, when the port is not beside
it, or when JAX or the JAX package was loaded.  The last line of
standard output is the result as one JSON object; the numbers compared
with the reference, each beside its limit, are the last lines of
standard error and the result's last key.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the repository root (for ``bench``) and the port's sources, not bench/
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def _process_age() -> float:
    """Seconds since this process started (``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _finite(v) -> bool:
    return not isinstance(v, float) or v == v and abs(v) != float("inf")


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = T_START - _process_age()

    from bench import cell, manifest
    bench = manifest.load()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"[bench] needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    cell.say(f"{args.workload} seed {args.seed}, {args.seconds:g} s, trace "
             f"{args.trace}; card {cell.power_limit()}")
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda:0", t_process=t_process,
                      bench=bench)
    cell.refuse_forbidden("this process")
    result["checks"] = {k: {kk: (vv if _finite(vv) else None)
                            for kk, vv in c.items()}
                        for k, c in result["checks"].items()}
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
