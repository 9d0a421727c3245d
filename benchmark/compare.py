"""The numbers that decide ``correct``, each held to its limit.

Training (the program's first three steps through the window's own call,
against the reference's three from the same weights and batches):

* ``loss``: the largest relative gap of a step's loss;
* ``grad1``: the first gradient as the optimizer holds it after one step
  (Adam's first moment over 1 − β₁), by the worst leaf: the gap between the
  program's norm and the reference's, over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
* ``change3``: the parameters' change after the three steps, by the worst
  leaf in the same way;
* ``grad1_diff``: the first gradient itself, by the worst leaf: the norm of
  the difference between the program's and the reference's, over the same
  denominator.  A gap of norms moves with the square of the per-element
  error (the errors add in quadrature), so it hardly tells a lower
  precision; the norm of the difference moves with the error itself.

* ``teacher_gap``: the frozen teacher's representations that the first
  step's loss read (the towers it runs live, not those a batch carries),
  by the worst row: ``‖t − t_ref‖ / ‖t_ref‖``;
* ``student_gap``: the students' outputs at the first step, by the worst row
  of either tower, in the same way;
* ``parts1``: the first step's loss parts (each loss times its scale, by
  the program's names for them), by the worst part: ``|p − p_ref|`` over
  ``|p_ref|`` or the median part's, whichever is larger.  A part the
  program does not report reads infinite.

Leaves whose reference gradient is below a thousandth of the median leaf's
are left out of the leaf numbers: Adam moves them by round-off alone.

Scoring: ``score_gap``, the largest absolute gap between a score the stream
yielded in the window and the reference's score of the same pair.
"""

from __future__ import annotations

import statistics

NOUGHT_SHARE = 1e-3


def _worst_leaf(prog: dict, ref: dict, keep: list, scale: dict = None) -> tuple:
    """(the worst leaf's |prog − ref| over ``scale``'s norm of that leaf or of
    the median leaf, whichever is larger (``scale`` is ``ref`` by default),
    its name)."""
    scale = scale or ref
    median = statistics.median(scale[k] for k in keep)
    return max((abs(prog[k] - ref[k]) / max(scale[k], median), k) for k in keep)


def rows_gap(prog: list, ref: list) -> float:
    """The worst row's ``‖p − r‖ / ‖r‖`` over paired ``[rows, width]``
    tensors; infinite where the program kept none, not each of them, or
    not each row."""
    if (not prog or len(prog) != len(ref) or any(a is None for a in prog)
            or any(a.shape != b.shape for a, b in zip(prog, ref))):
        return float("inf")
    return max(float(((a.to(b.device) - b).norm(dim=1) / b.norm(dim=1)).max())
               for a, b in zip(prog, ref))


def parts_gap(prog: dict, ref: dict) -> float:
    median = statistics.median(abs(v) for v in ref.values())
    return max(abs(prog.get(k, float("inf")) - v) / max(abs(v), median)
               for k, v in ref.items())


def train_numbers(prog: dict, ref: dict) -> dict:
    g = ref["grad1"]
    median = statistics.median(g.values())
    keep = [k for k in g if g[k] >= NOUGHT_SHARE * median]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad1, grad1_leaf = _worst_leaf(prog["grad1"], g, keep)
    change3, change3_leaf = _worst_leaf(prog["change"], ref["change"], keep)
    a, b = prog["grad1_vec"], ref["grad1_vec"]
    dist = {k: float((a[k].to(b[k].device) - b[k]).norm()) for k in keep}
    grad1_diff, diff_leaf = _worst_leaf(dist, {k: 0.0 for k in keep}, keep, g)
    out = {"loss": loss, "grad1": grad1, "change3": change3, "grad1_diff": grad1_diff,
           "student_gap": rows_gap(prog["students1"], ref["students1"]),
           "parts1": parts_gap(prog["parts1"], ref["parts1"])}
    if ref["teacher1"]:
        out["teacher_gap"] = rows_gap(prog["teacher1"], ref["teacher1"])
    return {**out, "grad1_leaf": grad1_leaf, "change3_leaf": change3_leaf,
            "grad1_diff_leaf": diff_leaf, "leaves_left_out": sorted(set(g) - set(keep))}


def held(numbers: dict, limits: dict) -> bool:
    """Every limited number read, finite and at most its limit."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= v
               for k, v in limits.items())
