"""Faults planted underneath the timed path, for the tests and the chip
readings that show the check catches them: each a context manager that
breaks the program in place and restores it on exit.

- ``state_unchanged``: every step returns its latents unchanged (the
  velocity reads zero).
- ``half_batch``: the DiT runs the CFG batch's first half only and hands
  the mean over it to every row.
- ``altered_answer``: one element of a step's velocity is altered where the
  step produces it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    import torch

    from physicedit_torch.sampling import denoise as D

    orig = D.unpatchify
    return _patched(D, "unpatchify", lambda t, h, w: torch.zeros_like(orig(t, h, w)))


def half_batch():
    from physicedit_torch.models.dit import DiT

    orig = DiT.forward

    def forward(self, img, txt, t, *args, **kwargs):
        n = img.shape[0] // 2
        kwargs["txt_key_mask"] = kwargs["txt_key_mask"][:n]
        out = orig(self, img[:n], txt[:n], t[:n], *args, **kwargs)
        return out.mean(0, keepdim=True).expand(img.shape[0], -1, -1)

    return _patched(DiT, "forward", forward)


def altered_answer():
    from physicedit_torch.sampling import denoise as D

    orig = D.unpatchify

    def unpatchify(t, h, w):
        v = orig(t, h, w).clone()
        v[..., 0, 0, 0] += 1.0
        return v

    return _patched(D, "unpatchify", unpatchify)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
