"""The numbers a training cell's `correct` compares, each a gap between
the program's reading and the plain reference's.

- `loss_gap`: over the first steps, the largest |loss - ref| / |ref|.
- `norm_gap`: by the worst leaf, | ||program leaf|| - ||reference leaf|| |
  over the larger of the reference leaf's norm and the median leaf's
  norm (some gradients are all but zero). Used for the first gradient
  as the optimizer holds it after one step, and for the parameters'
  change after the checked steps.
- `moving_leaves`: the leaves whose reference gradient is at least a
  thousandth of the median leaf's; the others move by round-off alone
  and are left out of the change's gap.
"""

from __future__ import annotations

import statistics

from harness import common


def loss_gap(program, reference) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def norm_gap(program, reference, counted=None) -> float:
    idx = range(len(reference)) if counted is None else counted
    ref = [reference[i] for i in idx]
    med = statistics.median(ref)
    return max(abs(program[i] - reference[i]) / max(reference[i], med)
               for i in idx)


def moving_leaves(ref_grad_norms, share: float = 1e-3) -> list:
    med = statistics.median(ref_grad_norms)
    return [i for i, g in enumerate(ref_grad_norms) if g >= share * med]


def compare(prog: dict, refr: dict, limits: dict) -> dict:
    """Each number a training cell compares, beside its limit."""
    moving = moving_leaves(refr["grad"])
    return {
        "loss_gap": common.check(loss_gap(prog["loss"], refr["loss"]),
                                 limits["loss_gap"]),
        "first_grad_gap": common.check(norm_gap(prog["grad"], refr["grad"]),
                                       limits["first_grad_gap"]),
        "change_gap": common.check(
            norm_gap(prog["change"], refr["change"], moving),
            limits["change_gap"]),
    }


def describe(names, prog: dict, refr: dict, file) -> None:
    """The worst leaves of each norm gap, on `file` (a diagnostic)."""
    print(f"readings: loss program {prog['loss']} reference {refr['loss']}",
          file=file)
    for key in ("grad", "change"):
        rows = sorted(((abs(p - r) / max(r, 1e-30), n, p, r) for n, p, r in
                       zip(names, prog[key], refr[key])), reverse=True)[:4]
        print(f"readings: {key} worst leaves " + "; ".join(
            f"{n} {p:.6g} vs {r:.6g} ({g:.3g})" for g, n, p, r in rows),
            file=file)
