"""Multi-tenant masked decode: many submodels in one batched decode.

The port of the reference's ``serving/server.py::EdgeServer``. The server
batches tenants with *different* submodel specs by running the
parent-space masked decode (``models.transformer.decode_step``) over a
fixed slot axis. Where the reference vmaps a batch-1 decode over slots,
the port writes that axis out as the batch dimension:

* per-slot positions — a (slots,) position tensor: each slot writes its
  own ring slot and masks its own cache validity;
* per-slot masks — head masks (slots, H), depth gates (slots, n_layers)
  and d_ff masks (slots, d_ff), expert masks (slots, E) on a MoE parent,
  SSD-head masks (slots, H_ssm) on an SSM parent (the shared hybrid block
  of zamba2 runs whole in every slot); the ``mlp`` / ``moe``
  ops turn them into per-slot prefix tensors for ``elastic_dense`` /
  ``grouped_matmul`` (the SSM decode is plain tensor ops, masked per
  slot), so one launch serves every spec (a MoE layer routes each slot
  as its own group, with its own capacity, as the reference's ``vmap``
  over slots does);
* no host syncs on the prefixes — no prefix is ever a Python int; tenant
  admit/evict changes tensor values only (the port's form of the
  reference's three-program bound).

Prefill runs one slot at a time (batch 1), as the reference does, and its
caches — every field of every segment's (a pair's local and global), of
MLA's latents and of the shared block's sites — are copied into the
slot. Greedy sampling is argmax, as the reference's; ``temperature >
0`` samples with a ``torch.Generator`` (not held bit-equal to
``jax.random``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import transformer as T
from repro_torch.serving.batcher import Completion, ContinuousBatcher, Request


def _cache_fields(caches):
    """The tensors of a cache tree, in order: the fields of every
    NamedTuple (KVCache, MLACache, SSMCache), through a pair segment's
    ``{"local", "global"}`` dict and the per-site shared caches."""
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in _cache_fields(caches[k])]
    if isinstance(caches, (list, tuple)):
        return [t for c in caches for t in _cache_fields(c)]
    return [] if caches is None else [caches]


def _map_masks(fn, masks):
    """``fn`` over every array of a forward-mask dict (``depth`` holds a
    tuple of per-segment arrays)."""
    return {k: (tuple(fn(m) for m in v) if isinstance(v, tuple) else fn(v))
            for k, v in masks.items()}


class EdgeServer:
    """Multi-tenant batched decode server over a parent.

    params: parent-space params (a tree of tensors on ``device``).
    slots: fixed tenant axis (admit/evict churns values only).
    prompt_len: fixed prompt window — shorter prompts are front-padded
        with ``pad_token``, longer ones keep their last ``prompt_len``.
    backend: ``"auto"`` / ``"cuda"`` for the hand-written kernels, None
        for the dense masked path (``kernels/backend.py``).
    device: ``None`` runs on the card and raises when there is none;
        ``"cpu"`` runs on the CPU (the kernels' plain versions).
    """

    def __init__(self, family, params, *, slots: int = 4,
                 prompt_len: int = 32, max_new_tokens: int = 32,
                 backend: Optional[str] = None, temperature: float = 0.0,
                 seed: int = 0, pad_token: int = 0,
                 trace_logits: bool = False, device=None):
        if not getattr(family, "supports_decode", False):
            raise ValueError(
                f"family {family.name!r} has no cached decode path")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the server on "
                             f"{self.device}")
        self.family = family
        self.cfg = family.cfg
        self.params = params
        self.slots = slots
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.max_len = prompt_len + max_new_tokens
        self.temperature = temperature
        self.pad_token = pad_token
        self.trace_logits = trace_logits
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._kernels = kernel_dispatch(backend).table(family.name)

        self.batcher = ContinuousBatcher(slots)
        self._caches = T.init_decode_caches(self.cfg, slots, self.max_len,
                                            torch.float32, self.device)
        # per-slot forward masks with a leading slot axis; empty slots hold
        # the full-parent masks so the shapes never change
        self._masks = _map_masks(
            lambda m: torch.as_tensor(np.stack([m] * slots),
                                      device=self.device),
            family.decode_masks(family.full_spec()))
        self._slot_pos = np.zeros((slots,), np.int64)
        self._slot_tok = np.zeros((slots,), np.int64)

    # -- internals ---------------------------------------------------------
    def _fit_prompt(self, prompt: np.ndarray) -> np.ndarray:
        p = np.asarray(prompt, np.int64).reshape(-1)
        if len(p) >= self.prompt_len:
            return p[-self.prompt_len:]
        pad = np.full((self.prompt_len - len(p),), self.pad_token, np.int64)
        return np.concatenate([pad, p])

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(n, V) logits on the device -> (n,) token ids on the device."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _admit_one(self, slot: int, req: Request) -> Optional[Completion]:
        toks = torch.as_tensor(self._fit_prompt(req.prompt)[None],
                               device=self.device)
        spec = req.spec if req.spec is not None else self.family.full_spec()
        fwd = _map_masks(lambda m: torch.as_tensor(m, device=self.device),
                         self.family.decode_masks(spec))
        logits, slot_caches = T.prefill(
            self.params, self.cfg, toks, self.max_len, masks=fwd,
            kernels=self._kernels)
        # every field of every stacked (L or n_sites, B, ...) cache: k, v
        # of an attention segment (both of a pair) and of the shared
        # block's sites, MLA's latents, an SSM segment's state and conv
        # histories
        for f, n in zip(_cache_fields(self._caches),
                        _cache_fields(slot_caches)):
            f[:, slot] = n[:, 0]
        for k, v in fwd.items():
            pairs = zip(self._masks[k], v) if isinstance(v, tuple) \
                else [(self._masks[k], v)]
            for full, m in pairs:
                full[slot] = m
        self._slot_pos[slot] = self.prompt_len
        tok = int(self._sample(logits)[0])
        self._slot_tok[slot] = tok
        return self.batcher.record(
            slot, tok, logits[0].cpu().numpy() if self.trace_logits else None)

    # -- public API --------------------------------------------------------
    def submit(self, request: Request) -> None:
        if request.max_new_tokens > self.max_new_tokens:
            # the cache budget is max_len = prompt_len + max_new_tokens
            request = dataclasses.replace(
                request, max_new_tokens=self.max_new_tokens)
        self.batcher.submit(request)

    def step(self) -> List[Completion]:
        """One scheduler tick: admit queued requests into free slots
        (prefill + first token), then run one batched decode step for all
        slots. Returns completions finished this tick."""
        done: List[Completion] = []
        for slot in self.batcher.admit():
            c = self._admit_one(slot, self.batcher.request_at(slot))
            if c is not None:
                done.append(c)
        active = self.batcher.occupied()
        if not active:
            return done
        toks = torch.as_tensor(self._slot_tok[:, None], device=self.device)
        pos = torch.as_tensor(self._slot_pos, device=self.device)
        logits, self._caches = T.decode_step(
            self.params, self.cfg, self._caches, toks, pos,
            masks=self._masks, kernels=self._kernels)
        sampled = self._sample(logits).cpu().numpy()
        logits_np = logits.cpu().numpy() if self.trace_logits else None
        for slot in active:
            self._slot_pos[slot] += 1
            tok = int(sampled[slot])
            self._slot_tok[slot] = tok
            c = self.batcher.record(
                slot, tok, logits_np[slot] if self.trace_logits else None)
            if c is not None:
                done.append(c)
        return done

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve ``requests`` to completion (continuous batching: slots
        are re-admitted as tenants finish)."""
        for r in requests:
            self.submit(r)
        done: List[Completion] = []
        while self.batcher.busy:
            done.extend(self.step())
        order = {r.uid: i for i, r in enumerate(requests)}
        return sorted(done, key=lambda c: order.get(c.uid, len(order)))
