"""What every cell's run shares: the spec read from `BENCHMARK.json`
and the files it names, the device checks, the check that JAX stayed
out of the process, statistics over a window, the profiler's reading
of the device, and the one JSON line a run prints.

A cell is found by name: `BENCHMARK.json` gives its configuration and
traffic names, `configs/<config>.json` and `traffic/<traffic>.json`
hold their numbers, `limits/<cell>.json` the limits its `correct` is
judged by, and `metrics/<metric>.py` the reader of each per-layer
metric. The traffic file's `kind` names the runner that runs it,
`harness/<kind>.py` (a module with a `run` function), and a served
configuration's `model_type` names the module that makes its weights,
its engine and its reference, `models/<model_type>.py` (the contract is
in `models/__init__.py`). So a cell of a new kind or a new served model
joins the benchmark by new files alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
#: modules that must not be in the process that prints a result,
#: compared by whole top-level name (the port's name begins with the
#: JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")
#: the runner of traffic kind <kind> is `harness/<kind>.py`
HARNESS_DIR = BENCH_DIR / "harness"
#: the served model of model_type <type> is `models/<type>.py`
MODELS_DIR = BENCH_DIR / "models"


class Spec:
    """One cell as BENCHMARK.json and its files define it."""

    def __init__(self, workload: str, bench_path: Path = None):
        bench_path = bench_path or ROOT / "BENCHMARK.json"
        bench = json.loads(Path(bench_path).read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"BENCHMARK.json has {sorted(cells)}")
        self.cell = cells[workload]
        self.name = workload
        self.chips = int(self.cell["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = load_config(self.config_entry["file"])
        self.traffic = load_traffic(self.cell["traffic"])
        self.limits = load_limits(workload)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _reports(m, workload)]


    @classmethod
    def from_parts(cls, name, chips, config, traffic, limits,
                   end_to_end, per_layer) -> "Spec":
        """A cell made from dicts (the tests' tiny cells)."""
        self = cls.__new__(cls)
        self.cell = {"name": name, "chips": chips}
        self.name, self.chips = name, int(chips)
        self.config_entry = {}
        self.config, self.traffic, self.limits = config, traffic, limits
        self.end_to_end, self.per_layer = end_to_end, per_layer
        return self


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_config(rel_path: str) -> dict:
    return json.loads((ROOT / rel_path).read_text())


def load_traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_limits(workload: str) -> dict:
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json")
                      .read_text())


def _load(path: Path, prefix: str):
    """The module of the file at `path`, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    return _load(BENCH_DIR / "metrics" / f"{name}.py", "metric_").read


def runner_kinds() -> list:
    """The traffic kinds that have a runner: each `harness/<kind>.py`
    that defines a top-level `run`."""
    return sorted(p.stem for p in HARNESS_DIR.glob("*.py")
                  if re.search(r"^def run\(", p.read_text(), re.M))


def runner(kind: str):
    """The runner module of traffic kind `kind`, `harness/<kind>.py`;
    exits naming the kinds there are when it has none."""
    kinds = runner_kinds()
    if kind not in kinds:
        raise SystemExit(f"benchmark: no runner for traffic kind {kind!r}: "
                         f"harness/ has runners {kinds}")
    return importlib.import_module(f"harness.{kind}")


def served_model(config: dict):
    """The module of `models/<model_type>.py` for a served configuration
    (its functions: `models/__init__.py`); exits naming the model files
    there are when it has none."""
    model_type = config.get("model_type")
    have = sorted(p.stem for p in MODELS_DIR.glob("*.py")
                  if p.stem != "__init__")
    if model_type not in have:
        raise SystemExit(f"benchmark: no served model for model_type "
                         f"{model_type!r}: models/ has {have}")
    return _load(MODELS_DIR / f"{model_type}.py", "served_model_")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of FORBIDDEN_MODULES present in `modules`
    (default sys.modules), compared whole."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# -------------------------------------------------------------- device
def require_cuda(chips: int) -> None:
    """Exit with code 3 and no result unless `chips` cards are here."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        raise SystemExit(3)


def card_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of card 0, or '' without
    it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def device_record(device, count: int, peak_bytes: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------- statistics
def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value; nan when there
    are none."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    if pos == lo or xs[lo] == xs[lo + 1]:
        return xs[lo]
    if math.isinf(xs[lo + 1]):
        return xs[lo + 1]
    return xs[lo] + (xs[lo + 1] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------ profiler
class DeviceTrace:
    """torch.profiler over one stretch of a run: the device's activity
    and the CUDA runtime calls that launch and wait for it. Host
    operators are not recorded: their callbacks slow the program's
    threads and read long to parse. `prepare()` (in set-up) pays the
    profiler's start-up; `start()` and `stop()` bracket the stretch with
    a synchronize each, and `window_s` is the host's clock between them.
    On the CPU (the tests) it records host activity only."""

    def __init__(self, device):
        self.device = device
        self.events = []
        self.window_s = 0.0
        self.active = False
        self._prof = None

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        self._prof = profile(activities=acts, acc_events=True,
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1))
        self._prof.__enter__()

    def start(self) -> None:
        if self._prof is None:
            self.prepare()
        sync(self.device)
        self._prof.step()
        sync(self.device)
        self.active = True
        self._t0 = time.perf_counter()

    def mark_end(self) -> None:
        """End the traced stretch: the events that start later (a loop
        winding down) are left out when the trace is read."""
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._end_ns = time.time_ns()  # the profiler's own clock
        self.active = False

    def finish(self) -> None:
        """Stop the profiler and read the stretch's events. Stopping it
        while another thread replays a CUDA graph can hang (seen on the
        card): a caller whose program runs such a thread ends it first."""
        self._prof.step()
        self._prof.__exit__(None, None, None)
        start = self._prof.profiler.kineto_results.trace_start_ns()
        cut_us = (self._end_ns - start) / 1e3
        self.events = [e for e in self._read(self._prof) if e[2] < cut_us]
        self._prof = None

    def stop(self) -> None:
        self.mark_end()
        self.finish()

    @staticmethod
    def _read(prof) -> list:
        """[(is_device, name, start_us, end_us)] of every event."""
        from torch.autograd import DeviceType

        out = []
        for e in prof.events():
            # a user annotation mirrored onto the device's timeline (the
            # profiler's step, NCCL's record_function) is no operation
            is_dev = (e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.name.startswith("ProfilerStep"))
            tr = e.time_range
            out.append((is_dev, e.name, float(tr.start), float(tr.end)))
        return out

    # ------------------------------------------------------- readings
    def summary(self) -> dict:
        """What the result line carries: busy and window seconds and the
        breakdown."""
        return {"busy_s": self.busy_s(), "window_s": self.window_s,
                "breakdown": self.breakdown()}

    def device_events(self):
        return [e for e in self.events if e[0]]

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the events whose name holds any needle."""
        return sum(e[3] - e[2] for e in self.device_events()
                   if any(n in e[1] for n in needles)) * 1e-6

    def kernel_count(self, *needles: str) -> int:
        return sum(1 for e in self.device_events()
                   if not needles or any(n in e[1] for n in needles))

    def kernel_durations(self, needle: str) -> list:
        """Device seconds of each event whose name holds `needle`, in the
        order they started."""
        return [(e[3] - e[2]) * 1e-6 for e in sorted(
            (e for e in self.device_events() if needle in e[1]),
            key=lambda e: e[2])]

    def busy_s(self, exclude=()) -> float:
        """Seconds in which some device operation ran (the union of the
        device events' intervals), leaving out the events whose name
        holds a needle of `exclude`."""
        spans = sorted((e[2], e[3]) for e in self.device_events()
                       if not any(n in e[1] for n in exclude))
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time grouped by the host's CUDA runtime call that covers each
        gap's middle (the innermost there; "(no host event)" where the
        host ran Python between calls), the longest first."""
        dev = self.device_events()
        by_name = {}
        for _, name, s, e in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        host = sorted((e for e in self.events if not e[0]),
                      key=lambda e: e[2])
        spans = sorted((e[2], e[3]) for e in dev)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        starts = [h[2] for h in host]
        import bisect

        idle = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            name = "(no host event)"
            # the innermost covering event: the latest-starting one that
            # still covers the middle (scan back a bounded stretch)
            for h in reversed(host[max(0, i - 400):i]):
                if h[3] >= mid:
                    name = h[1]
                    break
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps_out]}


# --------------------------------------------------------------- result
def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown=None) -> None:
    """Print the numbers compared beside their limits as the last lines
    on standard error, then the result as the last line of standard
    output, with `checks` as its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def check(value: float, limit: float) -> dict:
    """One compared number beside its limit (a number above its limit,
    or one that is not a number, fails)."""
    value = float(value)
    return {"value": value, "limit": float(limit),
            "ok": bool(math.isfinite(value) and value <= limit)}
