"""Faults planted in the program's timed path, to show that the comparison
catches them (perfbench/tests/test_faults.py on the CPU; perfbench/control.py
--fault on the card at a cell's own size). Each takes a `patch(owner, name,
value)` callable (pytest's monkeypatch.setattr, or `Patches.set`) and
replaces one function of the program:

- unchanged_state: the optimizer's step returns the state unchanged;
- half_batch: the loss is taken over the top half of the view's rows only
  (half of the batch left out, the mean taken over the rest);
- altered_pixel: one served pixel is altered where it is produced;
- half_view: half of a served view's rows are left out (zero).

A served view's render is altered in each renderer a serve stage calls.
Every module of the program is imported before a render is replaced, so
that none binds the altered function by name and keeps it after the undo.
"""
from __future__ import annotations

import torch


class Patches:
    """setattr with an undo, for use outside pytest."""

    def __init__(self):
        self._undo = []

    def set(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()


def unchanged_state(patch):
    from materialrefgs_torch.train import optim

    patch(optim.Adam, "step", lambda self, params, grads, lrs: None)


def half_batch(patch):
    from materialrefgs_torch.train import losses

    real = losses.calculate_loss

    def half(gt, pkg, opt, it, image_weight=None, *rest):
        H = gt.shape[0]

        def cut(x):
            return x[: H // 2] if torch.is_tensor(x) and x.dim() >= 2 and x.shape[0] == H else x

        return real(cut(gt), {k: cut(v) for k, v in pkg.items()}, opt, it, cut(image_weight), *rest)

    patch(losses, "calculate_loss", half)


def _served(patch, change):
    from perfbench.core.system import PROGRAM, Side

    side = Side(PROGRAM)

    def altered(real):
        def render(*a, **kw):
            pkg = real(*a, **kw)
            pkg["render"] = change(pkg["render"].clone())
            return pkg

        return render

    patch(side.envgs, "render_surfel2", altered(side.envgs.render_surfel2))
    for name in ("render_initial", "render_volume", "render_surfel"):
        patch(side.renderers, name, altered(getattr(side.renderers, name)))


def altered_pixel(patch):
    def change(img):
        img[0, 0] = 1.0 - img[0, 0]
        return img

    _served(patch, change)


def half_view(patch):
    def change(img):
        img[img.shape[0] // 2:] = 0.0
        return img

    _served(patch, change)


TRAIN_FAULTS = (unchanged_state, half_batch)
SERVE_FAULTS = (altered_pixel, half_view)
BY_NAME = {f.__name__: f for f in TRAIN_FAULTS + SERVE_FAULTS}
