"""The control of a cell's comparison, at the cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 --queries 2048

For each seed: the cell's corpus and query pool from the seed, the
first ``--queries`` rows of the pool answered by the control (the
reference's brute force in TF32, in the program's place), and those
answers judged by the same comparison a run makes.  Prints each seed's
numbers beside their limits; the control has to come out not correct.
The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path[0:1] = [str(Path(__file__).resolve().parents[1])]


def control_run(workload: str, seed: int, n_queries: int, device,
                bench=None, sizes=None) -> dict:
    from bench import cell, manifest
    bench = bench or manifest.load()
    c = manifest.cell(bench, workload)
    config, traffic = cell.with_sizes(
        manifest.config(bench, c["config"]), manifest.traffic(c["traffic"]),
        sizes)
    corpus = manifest.module("corpora", config["corpus"]["generator"])
    ref = manifest.module("references", config["reference"])
    spec = config["corpus"]
    queries = corpus.query_pool(spec, n_queries, seed, device).cpu().numpy()
    ids, dists = ref.control_answers(corpus.corpus_chunks(spec, seed, device),
                                     queries, int(traffic["k"]), device)
    answers = [(i, ids[i], dists[i]) for i in range(n_queries)]
    return ref.judge(answers, n_queries,
                     corpus.corpus_chunks(spec, seed, device), queries,
                     config["check"], int(spec["n"]), device)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        v = control_run(args.workload, seed, args.queries, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v["correct"], "checks": v["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
