"""Read the numbers a cell's check compares, on many seeds in one process,
and the control's beside them: the readings the limits in the traffic
files are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--seconds 5] [--control fp8|tf32] [--out cal.jsonl]

Each seed is a whole run of the cell (set-up, a short window, the check);
with ``--control`` the reference in that precision is read against the f32
reference on the same sample.  One JSON line per seed goes to ``--out`` and to
standard output.  The benchmark's own runs never run the control.
"""

import time

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.getcwd())
    from run import pin_caches

    pin_caches(os.getcwd())
    import torch

    from yardstick.drivers import Context, run_cell
    from yardstick.loader import load_benchmark

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_benchmark(os.getcwd())
    config, traffic = bench.config(args.workload), bench.traffic(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(config, traffic, seed, args.seconds, False, "cuda", t0)
        ctx.control, ctx.check_first = args.control, True
        run = run_cell(ctx)
        row = dict(workload=args.workload, seed=seed, control=args.control,
                   checks={k: v for k, (v, _) in run.checks.items()},
                   readings={k: v for k, v in run.counters.items()
                             if k.startswith("control.")},
                   setup_s=run.setup_s, attempted=run.attempted, failed=run.failed,
                   wall_s=time.perf_counter() - t0)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
