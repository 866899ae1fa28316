"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's set-up (import, kernel
library, weights made on the card from the seed, warm-up of the cell's
own shapes) is timed as `setup_s`; then the window runs for `--seconds`
and gives the cell's end-to-end metrics (`--trace 0`) or, under the
profiler, its per-layer metrics (`--trace 1`). After the window the
outputs are judged against the plain reference (`correct`), and the
last line of standard output is one JSON object.

Exits with code 3 and prints no result when the cell's CUDA devices are
missing, and with code 4 when `jax`, `jaxlib`, `flax` or the JAX package
was loaded into the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(1, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


#: a run that has not ended by then prints every thread's stack on
#: standard error and exits with code 1 (the limit on a run is 360 s)
WATCHDOG_S = 330


def main(argv=None, device=None, spec=None, t_start=None) -> int:
    """Run the cell. `device` (the tests: the CPU) skips the look for
    CUDA devices, and `spec` replaces the cell BENCHMARK.json names."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True,
                                      file=sys.__stderr__)
    try:
        return _main(argv, device, spec, t_start)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _main(argv, device, spec, t_start) -> int:
    args = parse(argv)
    from harness import common

    spec = spec or common.Spec(args.workload)
    t_start = T_START if t_start is None else t_start
    runner = common.runner(spec.traffic["kind"])
    if device is None and hasattr(runner, "prelaunch"):
        # rank processes start first and pay their own set-up meanwhile
        args.prelaunched = runner.prelaunch(spec, args, t_start)
    import torch

    if device is None:
        try:
            common.require_cuda(spec.chips)
        except SystemExit:
            if getattr(args, "prelaunched", None) is not None:
                args.prelaunched.stop()
            raise
        device = torch.device("cuda", 0)
        if spec.chips == 1:
            torch.cuda.set_device(device)
    res = runner.run(spec, args, device, t_start)
    bad = common.forbidden_loaded()
    if bad:
        print(f"benchmark: {bad} loaded into the process", file=sys.stderr)
        return 4
    if args.trace:
        metrics = {}
        for m in spec.per_layer:
            value = common.metric_reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec.end_to_end}
    dev = common.device_record(device, spec.chips, res["peak"])
    breakdown = None
    if args.trace:
        dev["busy_s"] = res["trace"]["busy_s"]
        dev["window_s"] = res["trace"]["window_s"]
        breakdown = res["trace"]["breakdown"]
    print(f"benchmark: {spec.name} seed {args.seed}: set-up parts "
          f"{res['setup_parts']}; card {common.card_power_limit()!r}",
          file=sys.stderr)
    checks = res["checks"]
    common.emit(all(c["ok"] for c in checks.values()), res["attempted"],
                res["failed"], metrics, dev, checks, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
