"""Run chip_smoke.py's phases 21 (rntn) and 22 (clusters) alone on one
CUDA card, after phase 20 (d) (BASELINE config 3c) for the word vectors
they need: no kernel is built, since neither path launches K1-K4.

    python3 tools/tree_cluster_phases.py NAME [PROBES]

writes every record to chiprun_out/NAME.json and prints a summary;
PROBES (default chip_smoke's RNTN_PROBES, 64) sets how many test trees
phase 21 (c) runs through predict and forward_propagate_tree (2,210
probes every test tree). Exits 1 when a phase's gates fail.
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
    name = sys.argv[1]
    if len(sys.argv) > 2:
        cs.RNTN_PROBES = int(sys.argv[2])
    if not torch.cuda.is_available():
        print("tree_cluster_phases: no CUDA device is available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    shared = {}
    record = {"card": cs.nvidia_smi()}
    t0 = time.perf_counter()
    record["config3c"] = cs.nlp_paragraph_vectors(device, 0, shared)
    record["config3c"]["seconds"] = time.perf_counter() - t0
    shared["barnes_hut"] = cs.start_barnes_hut(shared["config3c"], 0)
    try:
        for phase, fn in (("rntn", cs.phase_rntn),
                          ("clusters", cs.phase_clusters)):
            t0 = time.perf_counter()
            res = fn(device, 0, shared)
            res["seconds"] = time.perf_counter() - t0
            record[phase] = res
            print(json.dumps({"phase": phase, "ok": res["ok"],
                              "seconds": res["seconds"]}), flush=True)
    finally:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", f"{name}.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
    return 0 if all(record[p]["ok"] for p in ("rntn", "clusters")) else 1


if __name__ == "__main__":
    sys.exit(main())
