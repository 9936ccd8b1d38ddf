"""The ten architectures of the reference zoo, copied into the port.

Every config cites its source in its comment line; structural numbers are
the reference's (`src/repro/configs/archs.py`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (INPUT_SHAPES, MLAConfig, ModelConfig,
                                      MoEConfig, Segment, SSMConfig,
                                      uniform_segments)

# ---------------------------------------------------------------------------
# [audio] hubert-xlarge — encoder-only, arXiv:2106.07447
# 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504
HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    segments=uniform_segments(48),
    act="gelu",
    mlp_gated=False,
    norm_type="layernorm",
    rope_theta=10_000.0,
    causal=False,
    encoder_only=True,
    frontend="audio",          # conv feature extractor is a stub
    tie_embeddings=False,
)

# ---------------------------------------------------------------------------
# [dense] granite-3-8b — GQA, hf:ibm-granite/granite-3.0-*-base
# 40L d_model=4096 32H kv=8 d_ff=12800 vocab=49155
GRANITE_3_8B = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    segments=uniform_segments(40),
)

# ---------------------------------------------------------------------------
# [vlm] llava-next-mistral-7b — anyres tiling (vision stub),
# hf:llava-hf/llava-v1.6-mistral-7b-hf; mistral-7B backbone
# 32L d_model=4096 32H kv=8 d_ff=14336 vocab=32000
LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    segments=uniform_segments(32),
    frontend="vision",
    # anyres: base 576 patch tokens + 4 tiles * 576 = 2880 image tokens
    frontend_tokens=2880,
    tie_embeddings=False,
)

# ---------------------------------------------------------------------------
# [dense] gemma2-9b — local+global alternating, logit softcap, arXiv:2408.00118
# 42L d_model=3584 16H kv=8 d_ff=14336 vocab=256000, head_dim=256
GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    segments=(Segment(kind="attn_pair", n_layers=21, pair_local_window=4096),),
    act="gelu",
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    sliding_window=4096,
)

# ---------------------------------------------------------------------------
# [moe] deepseek-v2-lite-16b — MLA kv_lora=512, arXiv:2405.04434
# 27L d_model=2048 16H d_ff=1408(expert) vocab=102400, 64 routed top-6 + 2 shared
# (assignment line: "MoE 64e top-6"; bracket mentions 160 routed — we follow
#  the structured line; first layer is dense per the HF config, d_ff=10944)
DEEPSEEK_V2_LITE = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,                  # dense first layer
    vocab_size=102400,
    segments=(Segment(kind="attn", n_layers=1, use_moe=False),
              Segment(kind="attn", n_layers=26, use_moe=True)),
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    rope_theta=10_000.0,
    tie_embeddings=False,
)

# ---------------------------------------------------------------------------
# [dense] gemma-7b — GeGLU, head_dim=256, arXiv:2403.08295
# 28L d_model=3072 16H kv=16 (MHA) d_ff=24576 vocab=256000
GEMMA_7B = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    segments=uniform_segments(28),
    act="gelu",
    embed_scale=True,
)

# ---------------------------------------------------------------------------
# [hybrid] zamba2-1.2b — Mamba2 backbone + shared attention blocks,
# arXiv:2411.15242
# 38L d_model=2048 32H kv=32 d_ff=8192 vocab=32000 ssm_state=64
# Shared transformer block applied every ~6 mamba layers (weights shared).
ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                  # d_ff of the shared attention block's MLP
    vocab_size=32000,
    segments=(Segment(kind="ssm", n_layers=6, shared_attn_after=True),) * 6
             + (Segment(kind="ssm", n_layers=2),),
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    shared_attn_d_ff=8192,
    sliding_window=4096,        # shared block uses SW attention at 500k
)

# ---------------------------------------------------------------------------
# [dense] qwen3-4b — qk_norm, GQA, hf:Qwen/Qwen3-*
# 36L d_model=2560 32H kv=8 d_ff=9728 vocab=151936
QWEN3_4B = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    segments=uniform_segments(36),
    qk_norm=True,
    rope_theta=1_000_000.0,
)

# ---------------------------------------------------------------------------
# [moe] granite-moe-1b-a400m — 32 experts top-8,
# hf:ibm-granite/granite-3.0-1b-a400m-base
# 24L d_model=1024 16H kv=8 d_ff=512(expert) vocab=49155
GRANITE_MOE_1B = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    segments=uniform_segments(24, use_moe=True),
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)

# ---------------------------------------------------------------------------
# [ssm] mamba2-2.7b — SSD, arXiv:2405.21060
# 64L d_model=2560 (attn-free) vocab=50280 ssm_state=128
MAMBA2_2_7B = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    segments=(Segment(kind="ssm", n_layers=64),),
    attn_type="none",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
)

ARCHS = {
    c.name: c for c in [
        HUBERT_XLARGE, GRANITE_3_8B, LLAVA_NEXT_MISTRAL_7B, GEMMA2_9B,
        DEEPSEEK_V2_LITE, GEMMA_7B, ZAMBA2_1_2B, QWEN3_4B, GRANITE_MOE_1B,
        MAMBA2_2_7B,
    ]
}

# long_500k support tiers:
#   native — sub-quadratic by architecture (SSM / hybrid / local-global /
#            MLA-compressed cache);
#   sw     — dense full-attention archs served with the sliding-window
#            variant (ring-buffer caches at window 4096);
# hubert is encoder-only: no decode shapes at all.
_LONG_NATIVE = {"mamba2-2.7b", "zamba2-1.2b", "gemma2-9b",
                "deepseek-v2-lite-16b"}
LONG_SW_WINDOW = 4096
_LONG_SW = {"granite-3-8b", "llava-next-mistral-7b", "gemma-7b",
            "qwen3-4b", "granite-moe-1b-a400m"}


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Serving variant for long_500k on dense full-attention archs: every
    attention layer becomes sliding-window (ring-buffer KV cache)."""
    if cfg.name in _LONG_SW and cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=LONG_SW_WINDOW)
    return cfg


def supported_pairs():
    """Every (arch, input shape) pair the zoo runs."""
    out = []
    for name, cfg in ARCHS.items():
        for sname in INPUT_SHAPES:
            if cfg.encoder_only and INPUT_SHAPES[sname].kind == "decode":
                continue
            if sname == "long_500k" and name not in (_LONG_NATIVE |
                                                     _LONG_SW):
                continue
            out.append((name, sname))
    return out
