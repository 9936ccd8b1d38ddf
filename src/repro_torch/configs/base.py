"""Config system: one `ModelConfig` describes every supported architecture.

The port's own copy of the reference config dataclasses (the port imports
nothing of the JAX package). Architectures are decomposed into *segments*:
homogeneous runs of layers; the port walks a segment's stacked layer
params with a Python loop over the leading ``n_layers`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int          # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0       # shared (always-on) experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    capacity_experts: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256        # SSD chunk length for the chunked train scan
    d_inner_override: Optional[int] = None

    def d_inner(self, d_model: int) -> int:
        if self.d_inner_override is not None:
            return self.d_inner_override
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of layers sharing one stacked parameter tree.

    kind:
      "attn"     — transformer blocks (attention + MLP/MoE)
      "ssm"      — mamba2 blocks
      "attn_pair"— pairs of (local, global) attention blocks (gemma2)
    """
    kind: str
    n_layers: int
    sliding_window: Optional[int] = None       # window for "attn" segments
    use_moe: bool = False
    # for "attn_pair": local window for even member; odd member is global
    pair_local_window: Optional[int] = None
    # hybrid: append the shared attention block after this segment
    shared_attn_after: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Segment, ...]

    # attention details
    attn_type: str = "gqa"            # gqa | mla | none
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    causal: bool = True

    # norms / mlp / embedding
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu | gelu
    mlp_gated: bool = True            # GLU-style MLP (SwiGLU/GeGLU)
    post_norms: bool = False          # gemma2 sandwich norms
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = True

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None

    # hybrid (zamba2): shared transformer block interleaved between segments
    shared_attn_d_ff: int = 0

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    encoder_only: bool = False

    # CFL elasticity: allowed width fractions
    elastic_widths: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)

    # ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (padded rows are unused classes)."""
        return -(-self.vocab_size // 256) * 256


def uniform_segments(n_layers: int, *, kind: str = "attn",
                     use_moe: bool = False,
                     sliding_window: Optional[int] = None
                     ) -> Tuple[Segment, ...]:
    return (Segment(kind=kind, n_layers=n_layers, use_moe=use_moe,
                    sliding_window=sliding_window),)


def reduced(cfg: ModelConfig, *, n_layers: int = 2,
            d_model: int = 256) -> ModelConfig:
    """Smoke-test variant: same family/feature set, tiny dims (the same
    rule as the reference's ``configs.base.reduced``)."""
    d_model = min(d_model, 512)
    head_dim = 32
    n_heads = max(2, d_model // (head_dim * 2))
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    else:
        n_kv = max(1, n_heads // max(1, cfg.q_per_kv))
    d_ff = d_model * 2
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                  d_ff_expert=d_model // 2,
                                  n_shared=min(cfg.moe.n_shared, 1))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                        v_head_dim=32)

    kinds = {s.kind for s in cfg.segments}
    if "attn_pair" in kinds:
        segs = [Segment(kind="attn_pair", n_layers=max(1, n_layers // 2),
                        pair_local_window=64)]
    elif "ssm" in kinds and any(s.shared_attn_after for s in cfg.segments):
        segs = [Segment(kind="ssm", n_layers=1, shared_attn_after=True),
                Segment(kind="ssm", n_layers=max(1, n_layers - 1))]
    elif "ssm" in kinds:
        segs = [Segment(kind="ssm", n_layers=n_layers)]
    else:
        use_moe = any(s.use_moe for s in cfg.segments)
        sw = cfg.sliding_window and min(cfg.sliding_window, 32)
        segs = [Segment(kind="attn", n_layers=n_layers, use_moe=use_moe,
                        sliding_window=sw)]

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_ff,
        vocab_size=min(cfg.vocab_size, 512),
        segments=tuple(segs),
        moe=moe,
        ssm=ssm,
        mla=mla,
        sliding_window=cfg.sliding_window and min(cfg.sliding_window, 32),
        shared_attn_d_ff=(d_model * 2 if cfg.shared_attn_d_ff else 0),
        frontend_tokens=min(cfg.frontend_tokens, 16),
    )
