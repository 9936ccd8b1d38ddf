"""K5's launch plan (``kernels/grouped_matmul.py::_plan``), on the CPU.

The card runs the grouped expert-prefix matmul (``csrc/grouped_matmul.cu``)
in one of three variants: ``tile``, a 3×TF32 tensor-core tile of 80 or
128 rows, whichever fills its last row tile best (160 capacity rows are
two whole 80-row tiles; dws's 1024 or 512 rows whole 128-row ones);
``stream``, the same kernel with at most 64 rows a block, streaming the
shared weights of the serving path; ``simt``, the first design, for rows
that cp.async cannot copy.
These tests compute the plan for an H100's 132 SMs at the main path's
shapes (granite-moe-1b-a400m: ``chip_smoke.py`` phases 8–10) and at the
edges, and show that no prefix reaches it. On a card (``-m cuda``) each
variant is held to its plain version and counted by variant.
"""
import inspect
import os
import sys

import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerance and cases)

torch.set_num_threads(2)
SMS = 132
PG, WT, XT = gm.W_PER_GROUP, gm.W_TRANS, gm.X_TRANS

# (label, G, E, M, K, N, flags, variant): the six training products of one
# MoE layer (4 clients, 32 experts, 160 capacity rows, d_model 1024, expert
# d_ff 512) and the serving path's decode and prefill on shared weights
MAIN_PATH_PLANS = [
    ("train up/gate fwd", 4, 32, 160, 1024, 512, PG, "tile"),
    ("train down fwd", 4, 32, 160, 512, 1024, PG, "tile"),
    ("train dxs up", 4, 32, 160, 512, 1024, PG | WT, "tile"),
    ("train dxs down", 4, 32, 160, 1024, 512, PG | WT, "tile"),
    ("train dws up", 4, 32, 1024, 160, 512, PG | XT, "tile"),
    ("train dws down", 4, 32, 512, 160, 1024, PG | XT, "tile"),
    ("decode up/gate", 2, 32, 8, 1024, 512, 0, "stream"),
    ("decode down", 2, 32, 8, 512, 1024, 0, "stream"),
    ("prefill up/gate", 1, 32, 16, 1024, 512, 0, "stream"),
]


@pytest.mark.parametrize("label,G,E,M,K,N,flags,variant", MAIN_PATH_PLANS,
                         ids=[c[0] for c in MAIN_PATH_PLANS])
def test_plan_main_path_takes_tensor_core_variants(label, G, E, M, K, N,
                                                   flags, variant):
    """Training takes the tile without a split (every SM has blocks to
    spare) and without an empty row: 80 rows for the 160 capacity rows of
    the forward and dxs, 128 for dws's rows (the model's widths). Serving
    streams the weights in 16-row tiles, split so that one wave of blocks
    fills every resident slot of the card; the ring fits two (tile) or
    three (stream) blocks an SM."""
    plan = gm._plan(G, E, M, K, N, flags, True, SMS)
    assert plan.variant == variant
    assert plan.kchunk % gm.STAGE_K == 0
    assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk
    blocks = gm.plan_blocks(plan, G, E, M, N, flags)
    per_sm = gm.resident_blocks(variant, plan.bm, flags)
    if variant == "tile":
        assert plan.bm == (80 if M == 160 else 128) and M % plan.bm == 0
        assert plan.splits == 1 and blocks >= SMS and per_sm == 2
    else:
        assert plan.bm == 16 and per_sm == 3
        assert SMS <= blocks <= per_sm * SMS


def test_plan_never_sees_the_prefixes():
    """The plan is a function of the shapes, the layout flags, the rows'
    alignment and the SM count; ``launch_plan`` of the operands alone."""
    assert list(inspect.signature(gm._plan).parameters) == [
        "G", "E", "M", "K", "N", "flags", "aligned", "sms"]
    assert list(inspect.signature(gm.launch_plan).parameters) == ["xs", "ws"]


def test_plan_unaligned_or_doubly_transposed_take_the_simt_tile(
        monkeypatch):
    """Rows, strides or starts off 16 bytes (cp.async cannot copy them) and
    x and w both transposed: the SIMT tile, by shape alone; aligned twins
    take the tensor-core variants."""
    monkeypatch.setattr(gm, "_sms", lambda index: SMS)
    f32 = dict(dtype=torch.float32)
    simt = [
        (torch.zeros(3, 5, 13, 37, **f32), torch.zeros(3, 5, 37, 70, **f32)),
        (torch.zeros(2, 3, 10, 20, **f32), torch.zeros(3, 20, 30, **f32)),
        (torch.zeros(1 + 2 * 3 * 8 * 64).narrow(0, 1, 2 * 3 * 8 * 64)
         .view(2, 3, 8, 64), torch.zeros(3, 64, 128, **f32)),
        (torch.zeros(2, 3, 40, 160, **f32).transpose(-1, -2),
         torch.zeros(2, 3, 64, 40, **f32).transpose(-1, -2)),
    ]
    for x, w in simt:
        assert gm.launch_plan(x, w)[1].variant == "simt", (x.shape, w.shape)
    flags, plan = gm.launch_plan(torch.zeros(2, 3, 8, 64, **f32),
                                 torch.zeros(3, 64, 128, **f32))
    assert (flags, plan.variant, plan.bm) == (0, "stream", 16)
    layer = torch.zeros(4, 2, 32, 1024, 512, **f32)[:, 1]   # strided view
    flags, plan = gm.launch_plan(torch.zeros(4, 32, 160, 1024, **f32), layer)
    assert (flags, plan.variant) == (PG, "tile")


def test_plan_row_boundary_between_stream_and_tile():
    """Up to 64 rows a block (all groups' rows with shared weights, one
    pair's with per-group weights) the stream product in 16-, 32- or
    64-row tiles; above, or with a transposed operand, the tile of 80 or
    128 rows whose last row tile is fullest (ties: 128)."""
    for rows, bm in ((1, 16), (16, 16), (17, 32), (33, 64), (64, 64)):
        assert gm._plan(1, 4, rows, 256, 256, 0, True, SMS)[:2] == (
            "stream", bm)
        assert gm._plan(3, 4, rows, 256, 256, PG, True, SMS)[:2] == (
            "stream", bm)
    assert gm._plan(5, 4, 13, 96, 136, 0, True, SMS).variant == "tile"
    assert gm._plan(5, 4, 13, 96, 136, PG, True, SMS).variant == "stream"
    assert gm._plan(2, 3, 9, 33, 72, WT, True, SMS)[:2] == ("tile", 80)
    for rows, bm in ((65, 80), (80, 80), (81, 128), (128, 128), (200, 80),
                     (256, 128), (320, 80), (640, 128)):
        assert gm._plan(2, 3, rows, 64, 64, PG, True, SMS)[:2] == (
            "tile", bm), rows


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_k5_variants_match_plain_on_card():
    """Every K5 case of ``chip_smoke.k5_cases`` at a small MoE layer —
    tile, stream and simt, dead experts exactly zero — against the plain
    version on the card, each launch counted by its variant; runs only
    where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    gm.grouped_matmul.launches_by_variant = dict.fromkeys(gm.VARIANTS, 0)
    worst = chip_smoke.phase_moe_kernels(
        torch.device("cuda"), d_model=128, d_ff=96, n_experts=6, top_k=2,
        clients=3, tokens=160, slots=2, experts=[6, 3, 2])
    assert worst["grouped_matmul"] <= chip_smoke.K5_TOL
    by = gm.grouped_matmul.launches_by_variant
    assert by["tile"] > 0 and by["stream"] > 0 and by["simt"] > 0
