"""Run chip_smoke.py's phase 23 (elastic) alone on one CUDA card: the
kernel library is built first (phase 2's `_build`), since (a) trains the
attention stack through K1-K3 in the smoke's own process.

    python3 tools/elastic_phase.py OUT.json

writes the phase's record to OUT.json and prints a summary. Exits 1
when a gate fails.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    out_path = sys.argv[1]
    if not torch.cuda.is_available():
        print("elastic_phase: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    record = {"card": cs.nvidia_smi()}
    t0 = time.perf_counter()
    cs._build.library()
    cs._build.build()
    record["build_seconds"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        record["elastic"] = cs.phase_elastic(device, 0)
        record["elastic"]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase": "elastic",
                          "ok": record["elastic"]["ok"],
                          "seconds": record["elastic"]["seconds"]}),
              flush=True)
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return 0 if record["elastic"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
