"""The benchmark of the PyTorch/CUDA port ``ezaudio_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
metrics are found by name from ``BENCHMARK.json``; the generator of the
traffic's kind (``yardstick/drivers.py``) builds the port on the card with
weights drawn from the seed, warms up, runs the window (traced with
``--trace 1``), then checks what the window produced against the plain
reference (``yardstick/reference.py``).  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), ``setup_parts`` (seconds
from the start to the end of each set-up phase), and last ``checks``, each
number compared with its limit; the same comparisons end standard error.
Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; so it does if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "ezaudio_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; no
    library the port uses may load JAX by itself."""
    os.environ["EZAUDIO_TORCH_BUILD_DIR"] = os.path.join(root, "build", "ezaudio_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(bench, workload: str, run, trace: bool, device: dict) -> dict:
    from yardstick.loader import read_metrics

    checks = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    correct = bool(checks) and run.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": read_metrics(bench.metrics_of(workload, trace), run), "device": device}
    if trace and run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["setup_parts"] = run.setup_parts
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    pin_caches(ROOT)
    from yardstick.loader import load_benchmark

    bench = load_benchmark(ROOT)
    cell = bench.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import ezaudio_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    from yardstick.drivers import Context, run_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(bench.config(args.workload), bench.traffic(args.workload), args.seed,
                  args.seconds, bool(args.trace), "cuda", T_START)
    run = run_cell(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": run.memory_peak_bytes,
              "power": power_limit()}
    out = result_line(bench, args.workload, run, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
