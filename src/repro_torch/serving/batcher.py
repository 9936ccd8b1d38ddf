"""Continuous-batching request scheduler for the multi-tenant server.

Host-side bookkeeping only (copied from the reference's
``serving/batcher.py``; no tensors): requests queue until a slot frees,
admitted tenants occupy a fixed-index slot until their generation
budget is spent, and finished generations are handed back as
:class:`Completion` records. The slot count is the server's padded
tenant axis — churn changes which request owns a slot, never the
compiled program (the training engine's fixed-cohort trick, applied to
decode).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One tenant's generation request. ``spec`` is a family submodel spec
    (``None`` = the full parent); ``prompt`` is a 1-D int token array."""
    uid: Any
    spec: Any
    prompt: np.ndarray
    max_new_tokens: int = 32


@dataclasses.dataclass
class Completion:
    uid: Any
    spec: Any
    prompt: np.ndarray
    tokens: List[int]                     # generated token ids
    logits: Optional[List[np.ndarray]] = None   # per-step (V,) if traced


@dataclasses.dataclass
class _Slot:
    request: Request
    tokens: List[int]
    logits: List[np.ndarray]


class ContinuousBatcher:
    """Admit/evict slot scheduler over a fixed tenant axis."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._queue: Deque[Request] = deque()
        self._slots: Dict[int, _Slot] = {}

    # -- host-side queue ---------------------------------------------------
    def submit(self, request: Request) -> None:
        self._queue.append(request)

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._slots)

    def occupied(self) -> List[int]:
        return sorted(self._slots)

    # -- slot lifecycle ----------------------------------------------------
    def admit(self) -> List[int]:
        """Move queued requests into free slots; returns newly admitted
        slot indices (the server prefills exactly these)."""
        admitted = []
        for i in range(self.n_slots):
            if not self._queue:
                break
            if i in self._slots:
                continue
            self._slots[i] = _Slot(self._queue.popleft(), [], [])
            admitted.append(i)
        return admitted

    def request_at(self, slot: int) -> Request:
        return self._slots[slot].request

    def record(self, slot: int, token: int,
               logits: Optional[np.ndarray] = None) -> Optional[Completion]:
        """Record one generated token for ``slot``; when the request's
        budget is spent, evict the slot and return its Completion."""
        s = self._slots[slot]
        s.tokens.append(int(token))
        if logits is not None:
            s.logits.append(np.asarray(logits))
        if len(s.tokens) >= s.request.max_new_tokens:
            del self._slots[slot]
            return Completion(s.request.uid, s.request.spec,
                              s.request.prompt, s.tokens,
                              s.logits or None)
        return None
