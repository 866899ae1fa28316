"""The control readings that set the upper end of each limit a cell's
`correct` is judged by, on the chip, several seeds in one process:

    python3 benchmark/control.py --workload <cell> --seeds 11,22,33 \
        --seconds 10

Serving cells: for each seed the cell's program serves its mix for a
window, as a run does, and the sampled requests are judged twice: the
program's served tokens against the float32 reference (the lower
reading, as in a run), and the tokens that the reference computed in
float8 (the control, one step below the configuration's bfloat16) puts
first at the same positions (the upper reading). Training cells: the
reference computed in float8, and the faults planted in the reference
put in the program's place, against the float32 reference.

One JSON line per seed on standard output. The benchmark's own runs do
not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(1, str(Path(__file__).resolve().parent.parent))


def serve_controls(spec, seeds, seconds, device):
    from harness import serve
    from reference.fp8 import strict_float32

    mix = spec.traffic
    for seed in seeds:
        parts = {}
        served = serve.Served(spec, seed, device, parts)
        w = serve.drive(served, mix, seed, seconds)
        picked = serve.sample(w["client"], seed,
                              int(mix.get("sample_tokens", 512)))
        w["client"].cancel_rest()
        served.close()
        strict_float32()
        params32 = served.reference_params()
        gaps, judged = serve.widest_gaps(served.model, params32, served.dm,
                                         picked, ("float32", "fp8"))
        del params32
        print(json.dumps({"workload": spec.name, "seed": seed,
                          "program_gap": gaps["float32"],
                          "control_gap": gaps["fp8"], "judged": judged,
                          "requests_sampled": len(picked)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from harness import common
    import torch

    spec = common.Spec(args.workload)
    common.require_cuda(1)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    kind = spec.traffic["kind"]
    if kind == "serve":
        serve_controls(spec, seeds, args.seconds, device)
    else:
        common.runner(kind).controls(spec, seeds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
