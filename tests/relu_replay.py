"""Test support, not part of the port: record the CNN's ReLU decisions on
one path and replay them on another.

The CNN's ReLUs are discontinuous in their derivative: a pre-activation
within rounding noise of 0 takes the other side on another path's
rounding, and such a flip moves a client's gradient by up to ~1e-2 of its
largest entry (a CPU rehearsal of the paper CNN against an fp64 forward
found flips at |v| ≈ 1e-6 in the reference's fp32 path and the port's
alike). After one flip two free-running paths drift apart chaotically. As
the MoE checks replay routes, the CNN checks replay ReLU decisions, so that
two paths compute the same function and can be held to the fp32
tolerances.

``ReluDecisions`` patches ``torch.nn.functional.relu`` while it is
entered: ``record`` keeps every call's ``x > 0`` mask in call order;
``count`` lets a path take its own decisions and counts those that differ
from the record (while the shapes follow it); ``replay`` makes each call
take the recorded decision (``where(mask, x, 0)``: value and gradient).
Past the end of the record a path takes its own decisions again.

Used by ``tests/test_torch_session.py`` on the CPU and by
``chip_smoke.py``'s CNN phase on the card. Imports torch only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class ReluDecisions:
    """``with relus("record"):`` ... ``with relus("replay"):`` ...; a
    shape that disagrees with the record raises ``error``."""

    def __init__(self, error=RuntimeError):
        self._real = F.relu
        self._error = error
        self.masks, self.mode, self.pos = [], None, 0
        self.calls, self._flips, self.decisions = 0, [], 0

    def __call__(self, mode):
        self.mode, self.pos = mode, 0
        return self

    def __enter__(self):
        F.relu = self._relu
        return self

    def __exit__(self, *exc):
        F.relu = self._real
        self.mode = None

    def _relu(self, t, inplace=False):
        self.calls += 1
        if self.mode == "record":
            self.masks.append(t.detach() > 0)
            return self._real(t)
        if self.pos >= len(self.masks):
            self.mode = "off"              # past the record: own decisions
        if self.mode in (None, "off"):
            return self._real(t)
        m = self.masks[self.pos]
        self.pos += 1
        if m.shape != t.shape:
            raise self._error(f"ReLU call {self.pos}: shape "
                              f"{tuple(t.shape)} against the record's "
                              f"{tuple(m.shape)}")
        if self.mode == "count":
            self._flips.append(((t.detach() > 0) != m).sum())
            self.decisions += m.numel()
            return self._real(t)
        return torch.where(m, t, torch.zeros((), dtype=t.dtype,
                                             device=t.device))

    def flips(self, per=None):
        """Decisions the counted path took the other way: in all, or in
        consecutive groups of ``per`` calls (one forward each)."""
        counts = [int(f) for f in self._flips]
        if per is None:
            return sum(counts)
        return [sum(counts[i:i + per]) for i in range(0, len(counts), per)]
