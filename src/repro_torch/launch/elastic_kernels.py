"""The tile-accounting gate: spec width against the tiles, DMA blocks and
time of every tile-skipping kernel.

The port of the reference's ``benchmarks/elastic_kernels.py``, as a module
of the package (it writes no file). It sweeps the active fraction
(``FRACS``) of every tile-skipping op — the MLP's output-prefix up and
contraction-prefix down projection (K1), the MoE expert-prefix grouped
matmul (K5), the MoE dispatch / combine row movement (K6 / K7), the SSD
head prefix (K8, and K8 + K9 backward), flash attention's head prefix
(K2, and K3 + K4 backward) and the CNN's channel-prefix conv (B2 lowered
onto K1) — and gives per sweep point and pass (``fwd`` / ``bwd``) a row:

* ``tiles_executed`` / ``tiles_total`` / ``dma_blocks`` — the host model
  of the launches the op makes (``launch/roofline.py``, from each wrapper's
  own plan);
* ``counted_tiles`` / ``counted_dma`` (on the card) — the same counts taken
  by the kernels themselves, in their counted build
  (``kernels/build.py``, ``csrc/tile_counters.cuh``): they must equal the
  model exactly;
* ``max_err`` (on the card) — the reference's scale-relative ``_err`` of
  the kernel against its plain version evaluated in fp64 (so that it
  measures the kernel's own rounding, not the fp32 plain version's), the
  forward's output or the VJP's cotangents (``leaf_errs`` apart);
* ``ms`` (on the card) — the fast build's time by CUDA events (the
  backward rows: forward and backward, as the reference times
  ``jax.grad``); the ``dense-masked`` rows time the plain version, and
  ``share`` is a row's time over the full-width row's (back to back, a
  short op's events time the host's enqueue rather than its kernels).

Two row sets: ``bench``, the reference's shapes (``MLP_UP`` ...), and
``main``, the main path's widths (PERF.md §6: granite-3-8b's training MLP
and attention, granite-moe-1b-a400m's experts and dispatch, mamba2-2.7b's
SSD, the paper CNN's stage-1 blocks), each with every fraction of
``FRACS``. ``gate_elastic_rows`` then runs on each set, and a required
(op, pass) sweep missing from a set fails it.

  PYTHONPATH=src python -m repro_torch.launch.elastic_kernels --check
      (any host, no kernel: the model rows and the gate, in seconds)
  PYTHONPATH=src python -m repro_torch.launch.elastic_kernels
      (on the card: counters against the model, parity, times, the gate)
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import elastic_matmul as em
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.dispatch import attention_op, ssd_op
from repro_torch.kernels.elastic_conv import (elastic_conv2d,
                                              elastic_conv2d_plain)
from repro_torch.kernels.moe_dispatch import (gather_dot, gather_reduce,
                                              gather_reduce_plain,
                                              gather_rows, gather_rows_plain,
                                              moe_combine, moe_dispatch)
from repro_torch.launch import mesh
from repro_torch.launch import roofline as rf

FRACS = (0.25, 0.5, 0.75, 1.0)

# the reference's op shapes (benchmarks/elastic_kernels.py)
MLP_UP = (512, 512, 2048)            # M, K, N — x @ wi, output prefix
MLP_DOWN = (512, 2048, 512)          # M, K, N — h @ wo, contraction prefix
MOE = (8, 128, 256, 512)             # G, cap, d, ff — grouped expert prefix
SSD = (2, 128, 8, 32, 32, 32)        # B, S, H, P, N, chunk — head prefix
ATTN = (2, 128, 8, 64, 32, 32)       # B, S, H, D, bq, bk — causal, KV=H
DISP = (256, 2, 8, 64, 256)          # T, k, E, cap, d — token movement
CONV = (8, 16, 64)                   # B, HW, C — 3x3 SAME, channel prefix

# every (op, pass) sweep the gate must see — a leg silently dropped is a
# gate failure, not a silent coverage hole
REQUIRED_GROUPS = {
    ("mlp_up", "fwd"), ("mlp_up", "bwd"),
    ("mlp_down", "fwd"), ("mlp_down", "bwd"),
    ("moe_grouped", "fwd"), ("moe_grouped", "bwd"),
    ("moe_dispatch", "fwd"), ("moe_dispatch", "bwd"),
    ("ssd_heads", "fwd"), ("ssd_heads", "bwd"),
    ("attention", "fwd"), ("attention", "bwd"),
    ("conv_channels", "fwd"),
}


def _pct(f):
    return int(f * 100)


def _aligned(*strides):
    """Rows and strides the 16-byte copies can read, as the wrappers'
    ``_aligned`` on fresh (256-byte aligned) tensors."""
    return all(int(s) % 4 == 0 for s in strides)


def _err(a, b):
    """Scale-relative parity: max |a − b| over max(max |b|, 1) (the
    reference's ``_err``)."""
    if b.numel() == 0:
        return 0.0
    b = b.detach().double()
    scale = max(b.abs().max().item(), 1.0)
    return (a.detach().double() - b).abs().max().item() / scale


def _i32(vals, device):
    return torch.as_tensor(vals, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# the ops: each gives its launches' model and, on the card, its kernel and
# plain versions on seeded inputs
# ---------------------------------------------------------------------------
class Op:
    """One swept op. ``model(f, sms)`` -> {pass: Geometry};
    ``setup(f, device)`` -> (leaves, ctx); ``kernel`` / ``plain`` map
    (leaves, ctx) to the output; ``cot`` is the output cotangent."""

    op = tag = ""
    passes = ("fwd", "bwd")
    seed = 0

    def frac(self, f) -> float:
        return f

    def parity_sets(self, f, device) -> list:
        """Further (leaves, ctx) sets the row's parity is also held on
        (none by default)."""
        return []

    def _gen(self, device):
        return torch.Generator(device=device).manual_seed(self.seed)

    @staticmethod
    def _randn(shape, gen, device, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale


class MlpOp(Op):
    """K1 on an MLP projection: ``mlp_up`` skips output columns past
    ``int(f · N)``, ``mlp_down`` the contraction past ``int(f · K)`` (its
    input activations already zero there). G groups, shared or per-group
    weights."""

    def __init__(self, op, G, M, K, N, per_group):
        self.op = self.tag = op
        self.G, self.M, self.K, self.N = G, M, K, N
        self.per_group = per_group
        self.seed = 0 if op == "mlp_up" else 1

    def _prefixes(self, f):
        a = int(f * (self.N if self.op == "mlp_up" else self.K))
        return (None, a) if self.op == "mlp_up" else (a, None)

    def model(self, f, sms):
        G, M, K, N = self.G, self.M, self.K, self.N
        pg = em.W_PER_GROUP if self.per_group else 0
        ka, na = self._prefixes(f)

        def launch(M_, K_, N_, flags, aligned, ka_, na_, ma_):
            plan = em._plan(G, M_, K_, N_, flags, aligned, sms)
            return rf.edense_geometry(G, M_, K_, N_, flags, plan, ka_, na_,
                                      ma_)

        fwd = launch(M, K, N, pg, _aligned(K, N, K * N), ka, na, None)
        # the VJP (_EDense.backward): dx = K1(dy, wᵀ) with the prefixes
        # swapped, dw = K1(xᵀ, dy) per group
        dx = launch(M, N, K, em.W_TRANS | pg, _aligned(N, K * N), na, ka,
                    None)
        dw = launch(K, M, N, em.X_TRANS | em.W_PER_GROUP,
                    _aligned(K, N, M * N), None, na, ka)
        return {"fwd": fwd, "bwd": dx + dw}

    def setup(self, f, device):
        G, M, K, N = self.G, self.M, self.K, self.N
        if not hasattr(self, "_base"):
            gen = self._gen(device)
            self._base = (self._randn((G, M, K), gen, device),
                          self._randn((G, K, N) if self.per_group else (K, N),
                                      gen, device))
            self.cot = self._randn((G, M, N), gen, device)
        x, w = self._base
        ka, na = self._prefixes(f)
        if ka is not None:          # the up projection's masked output
            x = x * (torch.arange(K, device=device) < ka)
        ctx = {k: None if v is None else _i32([v] * G, device)
               for k, v in (("ka", ka), ("na", na))}
        return [x, w], ctx

    def kernel(self, leaves, ctx):
        x, w = leaves
        return em.elastic_dense(x, w, k_active=ctx["ka"], n_active=ctx["na"])

    def plain(self, leaves, ctx):
        x, w = leaves
        return em.elastic_dense_plain(x, w, k_active=ctx["ka"],
                                      n_active=ctx["na"])


class GroupedOp(Op):
    """K5: the grouped expert-prefix matmul, experts past
    ``max(1, int(f · E))`` skipped in every group."""

    op = tag = "moe_grouped"
    seed = 2

    def __init__(self, G, E, M, K, N, per_group):
        self.G, self.E, self.M, self.K, self.N = G, E, M, K, N
        self.per_group = per_group

    def _ga(self, f):
        return max(1, int(f * self.E))

    def frac(self, f):
        return self._ga(f) / self.E

    def model(self, f, sms):
        G, E, M, K, N = self.G, self.E, self.M, self.K, self.N
        pg = gm.W_PER_GROUP if self.per_group else 0
        wg = [E * K * N] if self.per_group else []
        ga = self._ga(f)

        def launch(M_, K_, N_, flags, strides):
            plan = gm._plan(G, E, M_, K_, N_, flags, _aligned(*strides), sms)
            return rf.gmm_geometry(G, E, M_, K_, N_, flags, plan, ga)

        fwd = launch(M, K, N, pg, [K, N, E * M * K, M * K, K * N] + wg)
        # _Grouped.backward: dxs = K5(dy, wsᵀ), dws = K5(xsᵀ, dy) per group
        dxs = launch(M, N, K, gm.W_TRANS | pg,
                     [N, N, E * M * N, M * N, K * N] + wg)
        dws = launch(K, M, N, gm.X_TRANS | gm.W_PER_GROUP,
                     [K, N, E * M * K, M * K, M * N, E * M * N])
        return {"fwd": fwd, "bwd": dxs + dws}

    def setup(self, f, device):
        G, E, M, K, N = self.G, self.E, self.M, self.K, self.N
        if not hasattr(self, "_base"):
            gen = self._gen(device)
            self._base = [self._randn((G, E, M, K), gen, device),
                          self._randn((G, E, K, N) if self.per_group
                                      else (E, K, N), gen, device)]
            self.cot = self._randn((G, E, M, N), gen, device)
        return list(self._base), {"ga": _i32([self._ga(f)] * G, device)}

    def kernel(self, leaves, ctx):
        return gm.grouped_matmul(*leaves, ctx["ga"])

    def plain(self, leaves, ctx):
        return gm.grouped_matmul_plain(*leaves, ctx["ga"])


def route(T, k, E, cap, e_act):
    """Deterministic synthetic routing (the reference's ``_route``): T·k
    assignments spread round-robin over the first ``e_act`` experts,
    overflow past ``cap`` dropped (dest = E·cap, the clamp target)."""
    a = np.arange(T * k) % e_act
    order = np.argsort(a, kind="stable")
    fill = np.zeros(E, np.int64)
    dest = np.empty(T * k, np.int64)
    for aid in order:
        e = a[aid]
        dest[aid] = e * cap + fill[e] if fill[e] < cap else E * cap
        fill[e] += 1
    kept = (dest < E * cap).astype(np.int64)
    slot_src = np.zeros(E * cap, np.int64)
    slot_valid = np.zeros(E * cap, np.int64)
    for aid in np.nonzero(kept)[0]:
        slot_src[dest[aid]] = aid // k
        slot_valid[dest[aid]] = 1
    return dest, kept, slot_src, slot_valid


class DispatchOp(Op):
    """K6 / K7: the MoE dispatch (gather) and combine (gather-reduce) of
    ``route`` over the first ``max(1, int(f · E))`` experts; the backward
    is the combine's scaled gather and gather-dot and the dispatch's
    gather-reduce."""

    op = tag = "moe_dispatch"
    seed = 5

    def __init__(self, T, k, E, cap, d):
        self.T, self.k, self.E, self.cap, self.d = T, k, E, cap, d
        self._routes = {}

    def _ea(self, f):
        return max(1, int(f * self.E))

    def frac(self, f):
        return self._ea(f) / self.E

    def _route(self, f):
        ea = self._ea(f)
        if ea not in self._routes:
            self._routes[ea] = route(self.T, self.k, self.E, self.cap, ea)
        return self._routes[ea]

    def _gates(self):
        if not hasattr(self, "_g"):
            g = torch.Generator().manual_seed(self.seed)
            self._g = torch.softmax(torch.randn((self.T, self.k),
                                                generator=g), -1).numpy()
        return self._g

    def model(self, f, sms):
        T, k, R, d = self.T, self.k, self.E * self.cap, self.d
        dest, kept, _, valid = self._route(f)
        gate_eff = self._gates() * kept.reshape(T, k)
        fwd = rf.gather_rows_geometry(valid, T, d) + \
            rf.gather_reduce_geometry(gate_eff, R, d)
        bwd = rf.gather_rows_geometry(valid, T, d) + \
            rf.gather_dot_geometry(gate_eff.reshape(-1) != 0, T, k, R, d) + \
            rf.gather_reduce_geometry(kept.reshape(T, k), R, d)
        return {"fwd": fwd, "bwd": bwd}

    def setup(self, f, device):
        T, k, E, cap, d = self.T, self.k, self.E, self.cap, self.d
        if not hasattr(self, "_xt"):
            gen = self._gen(device)
            self._xt = self._randn((T, d), gen, device)
            self.cot = self._randn((T, d), gen, device)
        dest, kept, src, valid = (_i32(a, device) for a in self._route(f))
        gates = torch.as_tensor(self._gates(), device=device)
        gate_eff = gates * kept.reshape(T, k)
        slot_gate = torch.zeros(E * cap + 1, device=device)
        slot_gate[dest.long()] = gate_eff.reshape(-1)
        ctx = dict(dest=dest, kept=kept, src=src, valid=valid,
                   slot_gate=slot_gate[:-1].contiguous())
        return [self._xt, gate_eff], ctx

    def kernel(self, leaves, c):
        xt, gate_eff = leaves
        eb = moe_dispatch(xt, c["src"], c["valid"], c["dest"], c["kept"],
                          n_experts=self.E, cap=self.cap)
        y_flat = (eb * 1.5).reshape(self.E * self.cap, self.d)
        return moe_combine(y_flat, gate_eff, c["dest"], c["src"], c["valid"],
                           c["slot_gate"])

    def plain(self, leaves, c):
        xt, gate_eff = leaves
        y_flat = gather_rows_plain(xt, c["src"], c["valid"]) * 1.5
        return gather_reduce_plain(y_flat, c["dest"].reshape(self.T, self.k),
                                   gate_eff)


class SsdOp(Op):
    """K8 (forward) and K8 + K9 (backward) through the dispatch's ``ssd``
    op, heads past ``max(1, int(f · H))`` skipped in every row.

    ``inputs="bench"``: the reference bench's (dt = softplus(N(0, 1)), one
    A = −exp(0.3 N(0, 1)) shared by the rows); ``"main"``: the main path's,
    as ``chip_smoke.py`` makes them for the SSM slices (dt uniform in
    [0.01, 0.3], each row its own A from −1 to −16). ``also``: further
    input kinds the row's parity is held on as well (the main widths on
    the bench's inputs, where dA = Σ du·dt cancels a thousandfold)."""

    op = tag = "ssd_heads"
    seed = 3

    def __init__(self, R, S, H, P, G, N, Q, inputs="bench", also=()):
        self.R, self.S, self.H, self.P, self.G, self.N, self.Q = \
            R, S, H, P, G, N, Q
        self.inputs = inputs
        self._also = [SsdOp(R, S, H, P, G, N, Q, inputs=k) for k in also]

    def parity_sets(self, f, device):
        return [op.setup(f, device) + (op.cot,) for op in self._also]

    def _ha(self, f):
        return max(1, int(f * self.H))

    def frac(self, f):
        return self._ha(f) / self.H

    def model(self, f, sms):
        R, S, H, P, G, N, Q = self.R, self.S, self.H, self.P, self.G, \
            self.N, self.Q
        aligned = N % 4 == 0
        fwd = rf.ssd_fwd_geometry(R, S, H, P, Q,
                                  ss.ssd_plan(R, H, P, N, Q, aligned, sms),
                                  self._ha(f))
        bwd = fwd + rf.ssd_bwd_geometry(
            R, S, H, P, G, Q, ss.ssd_bwd_plan(R, H, P, N, Q, aligned, sms),
            self._ha(f))
        return {"fwd": fwd, "bwd": bwd}

    def setup(self, f, device):
        R, S, H, P, G, N = self.R, self.S, self.H, self.P, self.G, self.N
        if not hasattr(self, "_base"):
            gen = self._gen(device)
            if self.inputs == "bench":
                dt = torch.nn.functional.softplus(
                    self._randn((R, S, H), gen, device))
                A = -torch.exp(self._randn((H,), gen, device, 0.3))
            else:
                dt = 0.01 + 0.29 * torch.rand((R, S, H), generator=gen,
                                              device=device)
                A = -torch.exp(torch.linspace(0.0, np.log(16.0), H,
                                              device=device))[None] * (
                    1.0 + 0.1 * torch.rand((R, 1), generator=gen,
                                           device=device))
            self._base = [self._randn((R, S, H, P), gen, device), dt,
                          A.contiguous(),
                          self._randn((R, S, G, N), gen, device),
                          self._randn((R, S, G, N), gen, device)]
            self.cot = self._randn((R, S, H, P), gen, device)
        ha = self._ha(f)
        hm = (torch.arange(H, device=device) < ha).float()
        return list(self._base), {"hm": hm, "ha": _i32([ha] * R, device)}

    def kernel(self, leaves, ctx):
        return ssd_op(*leaves, self.Q, head_mask=ctx["hm"])[0]

    def plain(self, leaves, ctx):
        return ss.ssd_scan_plain(*leaves, self.Q, ctx["ha"])


class AttentionOp(Op):
    """K2 (forward) and K3 + K4 (backward) through the dispatch's
    ``attention`` op, causal, query heads past ``max(1, int(f · H))``
    skipped in every row."""

    op = tag = "attention"
    seed = 6

    def __init__(self, B, S, H, KV, D):
        self.B, self.S, self.H, self.KV, self.D = B, S, H, KV, D

    def _ha(self, f):
        return max(1, int(f * self.H))

    def frac(self, f):
        return self._ha(f) / self.H

    def model(self, f, sms):
        B, S, H, KV, D = self.B, self.S, self.H, self.KV, self.D
        ha = self._ha(f)
        plan = fa.flash_bwd_plan(B, S, S, H, KV, D, True)
        fwd = rf.flash_fwd_geometry(B, S, S, H, True, None, ha)
        bwd = rf.flash_dq_geometry(B, S, S, H, plan, True, None, ha) + \
            rf.flash_dkv_geometry(B, S, S, H, KV, D, plan, True, None, ha)
        return {"fwd": fwd, "bwd": bwd}

    def setup(self, f, device):
        B, S, H, KV, D = self.B, self.S, self.H, self.KV, self.D
        if not hasattr(self, "_base"):
            gen = self._gen(device)
            self._base = [self._randn((B, S, H, D), gen, device),
                          self._randn((B, S, KV, D), gen, device),
                          self._randn((B, S, KV, D), gen, device)]
            self.cot = self._randn((B, S, H, D), gen, device)
        ha = self._ha(f)
        hm = (torch.arange(H, device=device) < ha).float()
        return list(self._base), {"hm": hm, "ha": _i32([ha] * B, device)}

    def kernel(self, leaves, ctx):
        return attention_op(*leaves, causal=True, head_mask=ctx["hm"])

    def plain(self, leaves, ctx):
        return fa.flash_attention_fwd_plain(*leaves, ctx["ha"],
                                            causal=True)[0]


class ConvOp(Op):
    """B2 lowered onto K1: a 3×3 SAME conv of G clients' (B, HW, HW, C)
    inputs, input and output channels past ``max(1, int(f · C))`` skipped
    (forward only, as the reference's sweep)."""

    op = tag = "conv_channels"
    passes = ("fwd",)
    seed = 4

    def __init__(self, G, B, HW, C, per_client):
        self.G, self.B, self.HW, self.C = G, B, HW, C
        self.per_client = per_client

    def _ca(self, f):
        return max(1, int(f * self.C))

    def frac(self, f):
        return self._ca(f) / self.C

    def model(self, f, sms):
        G, M, K, N = self.G, self.B * self.HW * self.HW, 9 * self.C, self.C
        flags = em.W_PER_GROUP if self.per_client else 0
        plan = em._plan(G, M, K, N, flags, _aligned(K, N, K * N), sms)
        ca = self._ca(f)
        return {"fwd": rf.edense_geometry(G, M, K, N, flags, plan, 9 * ca,
                                          ca, None)}

    def setup(self, f, device):
        G, B, HW, C = self.G, self.B, self.HW, self.C
        if not hasattr(self, "_base"):
            gen = self._gen(device)
            lead = (G,) if self.per_client else ()
            self._base = (self._randn((G, B, HW, HW, C), gen, device),
                          self._randn(lead + (3, 3, C, C), gen, device, 0.1),
                          self._randn(lead + (C,), gen, device, 0.1))
        x, w, b = self._base
        ca = self._ca(f)
        x = x * (torch.arange(C, device=device) < ca)
        return [x, w, b], {"ca": _i32([ca] * G, device)}

    def kernel(self, leaves, ctx):
        return elastic_conv2d(*leaves, stride=1, cin_active=ctx["ca"],
                              cout_active=ctx["ca"])

    def plain(self, leaves, ctx):
        return elastic_conv2d_plain(*leaves, stride=1, cin_active=ctx["ca"],
                                    cout_active=ctx["ca"])


def bench_ops() -> List[Op]:
    """The reference's shapes, G = 1 with shared weights (its launches have
    no group axis)."""
    (Mu, Ku, Nu), (Md, Kd, Nd) = MLP_UP, MLP_DOWN
    E, cap, d, ff = MOE
    B, S, H, P, N, Q = SSD
    Ba, Sa, Ha, D, _, _ = ATTN
    return [MlpOp("mlp_up", 1, Mu, Ku, Nu, False),
            MlpOp("mlp_down", 1, Md, Kd, Nd, False),
            GroupedOp(1, E, cap, d, ff, False), DispatchOp(*DISP),
            SsdOp(B, S, H, P, H, N, Q), AttentionOp(Ba, Sa, Ha, Ha, D),
            ConvOp(1, *CONV, False)]


def main_ops() -> List[Op]:
    """The main path's widths, as PERF.md §6's kernel table times them:
    granite-3-8b's training up / down projections (4 clients, 512 tokens,
    d_model 4096, d_ff 12800, per-client weights) and attention (16 rows of
    128 tokens, 32 heads, 8 KV heads, head_dim 128), granite-moe-1b-a400m's
    experts (4 clients × 32 experts × 160 capacity rows, 1024 → 512) and
    its dispatch (2048 tokens × top 8, d 1024, into T·k = 16384 slots: the
    reference's sweep fills every slot at full width, ``DISP``),
    mamba2-2.7b's SSD (16 rows of 512 tokens, 80 heads of 64, one group,
    d_state 128, chunk 256, the main path's inputs; its parity held on the
    reference bench's inputs too) and the paper CNN's
    stage-1 blocks (8 clients, batch 32, 8×8, 64 channels)."""
    return [MlpOp("mlp_up", 4, 512, 4096, 12800, True),
            MlpOp("mlp_down", 4, 512, 12800, 4096, True),
            GroupedOp(4, 32, 160, 1024, 512, True),
            DispatchOp(2048, 8, 32, 512, 1024),
            SsdOp(16, 512, 80, 64, 1, 128, 256, inputs="main",
                  also=("bench",)),
            AttentionOp(16, 128, 32, 8, 128),
            ConvOp(8, 32, 8, 64, True)]


def stress_ops() -> List[Op]:
    """Measured and counted, not gated: the dispatch at the main path's own
    capacity, 1.25 × T·k / E (20480 slots) — at full width a fifth of the
    slots stay empty while a 75 % expert prefix overflows its experts, so
    the rows moved (and read by the kernels) saturate at T·k. (The SSD at
    the main widths on the bench's inputs is gated: the main set's SSD row
    holds its parity there too.)"""
    return [DispatchOp(2048, 8, 32, 640, 1024)]


ROW_SETS = {"bench": bench_ops, "main": main_ops, "stress": stress_ops}
GATED = ("bench", "main")


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------
def _row(op, f, pas, geo, set_name, **extra):
    suffix = "" if pas == "fwd" else "_bwd"
    return dict(name=f"elastic_{op.tag}{suffix}_{_pct(f)}", set=set_name,
                op=op.op, frac=op.frac(f), kernel_path="tile-skipping",
                tiles_executed=geo.tiles, tiles_total=geo.total,
                dma_blocks=geo.dma, **{"pass": pas}, **extra)


def model_rows(set_name: str, sms: int = mesh.SMS) -> List[Dict]:
    """The model's tile-skipping rows of a row set (no kernel runs)."""
    rows = []
    for op in ROW_SETS[set_name]():
        for f in FRACS:
            geo = op.model(f, sms)
            rows.extend(_row(op, f, p, geo[p], set_name) for p in op.passes)
    return rows


def gate(rows: List[Dict]) -> List[str]:
    """The reference's gate over one row set, and its required sweeps."""
    groups = {(r["op"], r["pass"]) for r in rows
              if r.get("kernel_path") == "tile-skipping"}
    fails = [f"required sweep {need} absent" for need in
             sorted(REQUIRED_GROUPS - groups)]
    return fails + rf.gate_elastic_rows(rows)


def _ms(fn, iters=10, warmup=3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counted(fn) -> Tuple[int, int]:
    """(tiles, DMA blocks) the counted kernels record while ``fn`` runs."""
    with build.counting():
        build.reset_counters()
        fn()
        return build.read_counters()


def _grads(fn, leaves, ctx, cot):
    lv = [t.detach().requires_grad_(True) for t in leaves]
    return torch.autograd.grad(fn(lv, ctx), lv, cot)


def _f64(tensors):
    return [t.detach().double() for t in tensors]


def measure_op(op: Op, set_name: str, device, sms: int,
               iters: int = 10) -> Tuple[List[Dict], List[str]]:
    """One op's rows on the card: counters against the model, parity
    against the plain version, times; and the mismatches found."""
    rows, fails = [], []
    for f in FRACS:
        leaves, ctx = op.setup(f, device)
        geo = op.model(f, sms)
        for pas in op.passes:
            extra = op.parity_sets(f, device)
            if pas == "fwd":
                with torch.no_grad():
                    counted = _counted(lambda: op.kernel(leaves, ctx))
                    errs = [_err(op.kernel(lv, cx), op.plain(_f64(lv), cx))
                            for lv, cx in [(leaves, ctx)]
                            + [e[:2] for e in extra]]
                    ms = _ms(lambda: op.kernel(leaves, ctx), iters)
                    dense_ms = _ms(lambda: op.plain(leaves, ctx), iters)
            else:
                lv = [t.detach().requires_grad_(True) for t in leaves]
                with build.counting():
                    out = op.kernel(lv, ctx)
                    build.reset_counters()
                    torch.autograd.grad(out, lv, op.cot)
                    counted = build.read_counters()
                errs = [_err(a, b)
                        for lv, cx, cot in [(leaves, ctx, op.cot)] + extra
                        for a, b in zip(
                            _grads(op.kernel, lv, cx, cot),
                            _grads(op.plain, _f64(lv), cx, cot.double()))]
                ms = _ms(lambda: _grads(op.kernel, leaves, ctx, op.cot),
                         iters)
                dense_ms = _ms(lambda: _grads(op.plain, leaves, ctx, op.cot),
                               iters)
            g = geo[pas]
            row = _row(op, f, pas, g, set_name, counted_tiles=counted[0],
                       counted_dma=counted[1], max_err=max(errs),
                       leaf_errs=errs, ms=ms)
            if counted != (g.tiles, g.dma):
                fails.append(f"{set_name} {row['name']}: counted tiles / DMA "
                             f"{counted} != model {(g.tiles, g.dma)}")
            rows.append(row)
            rows.append(dict(name=row["name"].replace("elastic_", "dense_"),
                             set=set_name, op=op.op, frac=op.frac(f),
                             kernel_path="dense-masked", ms=dense_ms,
                             tiles_executed=g.total, tiles_total=g.total,
                             **{"pass": pas}))
    for pas in op.passes:             # time share of the full-width row
        for path in ("tile-skipping", "dense-masked"):
            rs = [r for r in rows if r["pass"] == pas
                  and r["kernel_path"] == path]
            for r in rs:
                r["share"] = r["ms"] / rs[-1]["ms"]
    return rows, fails


# ---------------------------------------------------------------------------
# edges: counters == model at prefix 0, ragged per-group prefixes that
# differ, shapes that are not tile multiples, every variant
# ---------------------------------------------------------------------------
def _edge_k1(device, gen):
    cases = []
    for G, M, K, N, pg, layout, pre in (
            (3, 37, 130, 70, True, "", ([0, 65, 130], [70, 33, 70],
                                        [37, 20, 5])),          # simt
            (2, 200, 264, 200, True, "", ([100, 264], [200, 77],
                                          [150, 0])),           # tile
            (3, 1, 1024, 1000, False, "", ([1024, 0, 300],
                                           [1000, 500, 129], None)),  # skinny
            (2, 96, 128, 160, True, "xw", ([128, 40], [0, 160],
                                           [96, 50]))):          # xᵀ, wᵀ
        if "x" in layout:
            x = torch.randn((G, K, M), generator=gen,
                            device=device).transpose(-1, -2)
        else:
            x = torch.randn((G, M, K), generator=gen, device=device)
        wshape = ((G,) if pg else ()) + ((N, K) if "w" in layout else (K, N))
        w = torch.randn(wshape, generator=gen, device=device)
        if "w" in layout:
            w = w.transpose(-1, -2)
        ka, na, ma = (None if p is None else _i32(p, device) for p in pre)
        flags, plan = em.launch_plan(x, w)
        cases.append((f"K1 {plan.variant} G{G} M{M} K{K} N{N} {layout}",
                      rf.edense_geometry(G, M, K, N, flags, plan, ka, na, ma),
                      lambda x=x, w=w, ka=ka, na=na, ma=ma: em.elastic_dense(
                          x, w, k_active=ka, n_active=na, m_active=ma)))
    return cases


def _edge_k5(device, gen):
    cases = []
    for G, E, M, K, N, pg, ga in ((3, 5, 37, 64, 96, True, [0, 3, 5]),
                                  (2, 4, 8, 256, 128, False, [1, 4]),
                                  (2, 3, 10, 30, 20, True, [2, 0])):
        xs = torch.randn((G, E, M, K), generator=gen, device=device)
        ws = torch.randn(((G,) if pg else ()) + (E, K, N), generator=gen,
                         device=device)
        ga = _i32(ga, device)
        flags, plan = gm.launch_plan(xs, ws)
        cases.append((f"K5 {plan.variant} G{G} E{E} M{M} K{K} N{N}",
                      rf.gmm_geometry(G, E, M, K, N, flags, plan, ga),
                      lambda xs=xs, ws=ws, ga=ga: gm.grouped_matmul(xs, ws,
                                                                    ga)))
    return cases


def _edge_flash(device, gen):
    cases = []
    for B, S, H, KV, D, causal, window, ha in (
            (3, 100, 4, 2, 64, True, None, [0, 3, 4]),
            (3, 100, 4, 2, 64, True, 40, [4, 1, 2]),
            (2, 70, 2, 1, 32, False, None, [1, 2])):
        q = torch.randn((B, S, H, D), generator=gen, device=device)
        k, v = (torch.randn((B, S, KV, D), generator=gen, device=device)
                for _ in range(2))
        do = torch.randn((B, S, H, D), generator=gen, device=device)
        ha = _i32(ha, device)
        o, lse = fa.flash_attention(q, k, v, ha, causal=causal,
                                    window=window)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        label = f"B{B} S{S} H{H} KV{KV} D{D} causal {causal} window {window}"
        cases.append((f"K2 {label}",
                      rf.flash_fwd_geometry(B, S, S, H, causal, window, ha),
                      lambda q=q, k=k, v=v, ha=ha, c=causal, w=window:
                      fa.flash_attention(q, k, v, ha, causal=c, window=w)))
        for variant in fa.FLASH_BWD_VARIANTS:
            plan = fa._bwd_plan(q, k, v, do, variant)
            args = (q, k, v, do, lse, delta, ha)
            kw = dict(causal=causal, window=window, variant=variant)
            cases.append((f"K3 {variant} {label}",
                          rf.flash_dq_geometry(B, S, S, H, plan, causal,
                                               window, ha),
                          lambda a=args, kw=kw:
                          fa.flash_attention_dq(*a, **kw)))
            cases.append((f"K4 {variant} {label}",
                          rf.flash_dkv_geometry(B, S, S, H, KV, D, plan,
                                                causal, window, ha),
                          lambda a=args, kw=kw:
                          fa.flash_attention_dkv(*a, **kw)))
    return cases


def _edge_rows(device, gen):
    cases = []
    T, k, R = 50, 3, 37
    for d in (96, 30):               # 16-byte vectors, and floats
        x = torch.randn((T, d), generator=gen, device=device)
        y = torch.randn((R, d), generator=gen, device=device)
        idx = torch.randint(0, T, (R,), generator=gen, device=device,
                            dtype=torch.int32)
        valid = (torch.rand((R,), generator=gen, device=device) < 0.6).int()
        scale = torch.rand((R,), generator=gen, device=device)
        dest = torch.randint(0, R + 3, (T * k,), generator=gen,
                             device=device, dtype=torch.int32)
        kept = (torch.rand((T * k,), generator=gen, device=device)
                < 0.7).int()
        gates = torch.rand((T, k), generator=gen, device=device) * \
            kept.reshape(T, k)
        z = torch.randn((T, d), generator=gen, device=device)
        v_np, g_np, k_np = (t.cpu().numpy() for t in (valid, gates, kept))
        for variant in ("first", "unrolled"):
            cases.append((f"K6 {variant} d{d}",
                          rf.gather_rows_geometry(v_np, T, d),
                          lambda v=variant, x=x, idx=idx, valid=valid:
                          gather_rows(x, idx, valid, variant=v)))
            cases.append((f"K7 {'split' if variant != 'first' else variant} "
                          f"d{d}", rf.gather_reduce_geometry(g_np, R, d),
                          lambda v=variant, y=y, dest=dest, gates=gates:
                          gather_reduce(y, dest.reshape(T, k), gates,
                                        variant="first" if v == "first"
                                        else "split")))
        cases.append((f"K6 scaled d{d}", rf.gather_rows_geometry(v_np, T, d),
                      lambda x=x, idx=idx, valid=valid, s=scale:
                      gather_rows(x, idx, valid, s)))
        cases.append((f"K6 gather-dot d{d}",
                      rf.gather_dot_geometry(k_np, T, k, R, d),
                      lambda y=y, dest=dest, kept=kept, z=z:
                      gather_dot(y, dest, kept, z, k)))
    return cases


def _edge_ssd(device, gen):
    cases = []
    for R, S, H, G, P, N, Q, ha in ((3, 96, 4, 2, 32, 16, 48, [0, 2, 4]),
                                    (2, 64, 3, 1, 32, 12, 32, [1, 3]),
                                    (2, 64, 4, 1, 64, 32, 64, [3, 1])):
        xh = torch.randn((R, S, H, P), generator=gen, device=device)
        dt = torch.nn.functional.softplus(
            torch.randn((R, S, H), generator=gen, device=device))
        A = -torch.exp(0.3 * torch.randn((H,), generator=gen, device=device))
        Bm, Cm = (torch.randn((R, S, G, N), generator=gen, device=device)
                  for _ in range(2))
        dy = torch.randn((R, S, H, P), generator=gen, device=device)
        ha = _i32(ha, device)
        plan = ss.launch_plan(xh, Bm, Cm, Q)
        _, states = ss.ssd_scan(xh, dt, A, Bm, Cm, Q, h_active=ha,
                                return_states=True)
        label = f"R{R} S{S} H{H} G{G} P{P} N{N} Q{Q}"
        cases.append((f"K8 {plan.variant} {label}",
                      rf.ssd_fwd_geometry(R, S, H, P, Q, plan, ha),
                      lambda a=(xh, dt, A, Bm, Cm, Q), ha=ha:
                      ss.ssd_scan(*a, h_active=ha)))
        bplan = ss.bwd_launch_plan(xh, Bm, Cm, states, dy, Q)
        for variant in sorted({bplan.variant, "simt"}):
            p = bplan if variant == bplan.variant else \
                ss.SsdBwdPlan("simt", H)
            cases.append((f"K9 {variant} {label}",
                          rf.ssd_bwd_geometry(R, S, H, P, G, Q, p, ha),
                          lambda a=(xh, dt, A, Bm, Cm, states, dy, Q), ha=ha,
                          v=variant: ss.ssd_scan_bwd_raw(*a, h_active=ha,
                                                         variant=v)))
    return cases


def edge_checks(device, seed=7) -> Tuple[List[str], List[str]]:
    """Counters against the model for direct kernel calls at the edges;
    returns (printed lines, mismatches)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lines, fails = [], []
    for make in (_edge_k1, _edge_k5, _edge_flash, _edge_rows, _edge_ssd):
        for label, geo, fn in make(device, gen):
            with torch.no_grad():
                counted = _counted(fn)
            ok = counted == (geo.tiles, geo.dma)
            lines.append(f"{label}: counted {counted}, model "
                         f"{(geo.tiles, geo.dma)} of {geo.total} tiles"
                         + ("" if ok else "  MISMATCH"))
            if not ok:
                fails.append(f"edge {label}: counted {counted} != model "
                             f"{(geo.tiles, geo.dma)}")
    return lines, fails


def format_row(r: Dict) -> str:
    if r["kernel_path"] != "tile-skipping":
        return (f"    {r['name']}: {r['ms']:.4f} ms, share "
                f"{r.get('share', 1.0):.3f}")
    ai = rf.tile_arithmetic_intensity(r)
    out = (f"    {r['name']}: tiles {r['tiles_executed']} / "
           f"{r['tiles_total']}, dma {r['dma_blocks']}, AI "
           f"{ai if ai is None else round(ai, 4)}")
    if "counted_tiles" in r:
        out += (f", counted ({r['counted_tiles']}, {r['counted_dma']}), "
                f"max_err {r['max_err']:.2e}"
                + (f" {['%.1e' % e for e in r['leaf_errs']]}"
                   if len(r["leaf_errs"]) > 1 else "")
                + f", {r['ms']:.4f} ms, share {r['share']:.3f}")
    return out


def run_card(device, set_names=tuple(ROW_SETS), iters=10):
    """Every row set on the card, then the edges; returns (rows, fails)."""
    sms = em._sms(device.index)
    rows, fails = [], []
    for name in set_names:
        set_rows = []
        for op in ROW_SETS[name]():
            t0 = time.perf_counter()
            r, f = measure_op(op, name, device, sms, iters)
            set_rows.extend(r)
            fails.extend(f)
            print(f"  {name} {op.op}: {time.perf_counter() - t0:.1f} s")
            for row in r:
                print(format_row(row))
        if name in GATED:
            fails.extend(f"{name}: {msg}" for msg in gate(set_rows))
        rows.extend(set_rows)
    lines, edge_fails = edge_checks(device)
    for line in lines:
        print(f"  edge {line}")
    return rows, fails + edge_fails


def check() -> int:
    """The gate on the model rows of both sets (no kernel runs)."""
    fails = []
    for name in ROW_SETS:
        rows = model_rows(name)
        for r in rows:
            print(format_row(r))
        groups = {(r["op"], r["pass"]) for r in rows}
        if name not in GATED:
            print(f"{name}: {len(rows)} rows, not gated: "
                  f"{rf.gate_elastic_rows(rows)}")
            continue
        set_fails = gate(rows)
        fails.extend(f"{name}: {m}" for m in set_fails)
        print(f"{name}: {len(rows)} tile-skipping rows, {len(groups)} "
              f"(op, pass) sweeps, gate "
              f"{'FAIL' if set_fails else 'PASS'}")
    if fails:
        print(f"ROOFLINE GATE FAIL ({len(fails)}):")
        for msg in fails:
            print(f"  - {msg}")
        return 1
    print("roofline gate PASS")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="the gate on the model rows (no kernel runs)")
    args = ap.parse_args(argv)
    if args.check:
        return check()
    from repro_torch.kernels.backend import resolve_device
    device = resolve_device("cuda")
    rows, fails = run_card(device)
    if fails:
        print(f"TILE-ACCOUNTING GATE FAIL ({len(fails)}):")
        for msg in fails:
            print(f"  - {msg}")
        return 1
    print(f"tile-accounting gate PASS: {len(rows)} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
