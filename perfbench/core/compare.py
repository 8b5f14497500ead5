"""The comparison with the plain reference that decides `correct`.

Training: the first steps through the window's own call, on the program
and on the reference from the same inputs. Compared: each step's loss, the
first gradient's norm per leaf as Adam got it, and the norm of each leaf's
change over the steps; a gap of norms (not the norm of a difference), taken
by the worst leaf against the reference's norm of that leaf or the median
leaf's, whichever is larger, since some gradients are all but zero. Leaves
whose reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change.

Serving: the served uint8 RGB of a sample of the window's views against the
reference's render of the same views: the largest difference of any
channel, in levels.

Each check is (name, value, limit), passing when value <= limit.
"""
from __future__ import annotations

import statistics

import torch

GRAD_RULE = 1e-3


def _median_nonzero(values) -> float:
    nz = [v for v in values if v > 0]
    return statistics.median(nz) if nz else 0.0


def train_gaps(mine: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(mine["loss"], ref["loss"]))
    g_med = _median_nonzero(ref["grad"].values())
    grad = max(abs(mine["grad"][k] - g) / max(g, g_med, 1e-30) for k, g in ref["grad"].items())
    kept = [k for k, g in ref["grad"].items() if g >= GRAD_RULE * g_med]
    c_med = _median_nonzero(ref["change"][k] for k in kept)
    change = max(abs(mine["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med, 1e-30) for k in kept)
    views = int(mine["views"] != ref["views"])
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "view_mismatch": views}


def train_checks(mine: dict, ref: dict, limits: dict) -> list:
    gaps = train_gaps(mine, ref)
    return [(k, gaps[k], float(limits[k])) for k in ("loss_gap", "grad_gap", "change_gap", "view_mismatch")]


def image_gap(mine: dict, theirs: dict) -> float:
    return max(float((mine[i].to(torch.int16) - theirs[i].to(torch.int16)).abs().max()) for i in mine)


def serve_checks(mine: dict, theirs: dict, limits: dict) -> list:
    return [("image_gap_levels", image_gap(mine, theirs), float(limits["image_gap_levels"]))]


def correct(checks: list) -> bool:
    return all(v <= lim for _, v, lim in checks)
