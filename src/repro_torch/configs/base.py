"""Config system: one `ModelConfig` describes every supported architecture.

The port's own copy of the reference config dataclasses, the input shapes
and the analytic helpers (parameter counts, FLOPs per token — what the
latency LUT prices — and ``config_fingerprint``); the port imports
nothing of the JAX package. Architectures are decomposed into *segments*:
homogeneous runs of layers; the port walks a segment's stacked layer
params with a Python loop over the leading ``n_layers`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Input shapes of the zoo (global shapes).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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

    # which input shapes this arch supports (None => all); decode shapes are
    # dropped automatically for encoder_only archs
    supported_shapes: Optional[Tuple[str, ...]] = None

    # CFL elasticity: allowed width fractions
    elastic_widths: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)

    # ------------------------------------------------------------------
    def supports(self, shape_name: str) -> bool:
        shape = INPUT_SHAPES[shape_name]
        if self.encoder_only and shape.kind == "decode":
            return False
        if self.supported_shapes is not None:
            return shape_name in self.supported_shapes
        return True

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (padded rows are unused classes)."""
        return -(-self.vocab_size // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count (the latency LUT's bytes)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for seg in self.segments:
            per_layer = 0
            if seg.kind in ("attn", "attn_pair"):
                per_layer += self._attn_params() + self._mlp_params(seg)
                per_layer += 2 * d  # norms
                if self.post_norms:
                    per_layer += 2 * d
            elif seg.kind == "ssm":
                per_layer += self._ssm_params() + d
            n = seg.n_layers * (2 if seg.kind == "attn_pair" else 1)
            total += per_layer * n
        if self.shared_attn_d_ff:
            # the shared block's params, counted once
            total += self._attn_params() + 2 * d * self.shared_attn_d_ff + \
                2 * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        per_expert = (3 if self.mlp_gated else 2) * d * m.d_ff_expert
        inactive = (m.n_experts - m.top_k) * per_expert
        n_moe_layers = sum(
            s.n_layers * (2 if s.kind == "attn_pair" else 1)
            for s in self.segments if s.use_moe)
        return self.param_count() - inactive * n_moe_layers

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_type == "mla":
            c = self.mla
            qk_dim = c.qk_nope_dim + c.qk_rope_dim
            p = d * self.n_heads * qk_dim                      # q proj
            p += d * (c.kv_lora_rank + c.qk_rope_dim)          # kv down
            p += c.kv_lora_rank * self.n_heads * (c.qk_nope_dim + c.v_head_dim)
            p += self.n_heads * c.v_head_dim * d               # o proj
            return p
        if self.attn_type == "none":
            return 0
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def _mlp_params(self, seg: Segment) -> int:
        d = self.d_model
        if seg.use_moe and self.moe is not None:
            m = self.moe
            per = (3 if self.mlp_gated else 2) * d * m.d_ff_expert
            return (m.n_experts + m.n_shared) * per + d * m.n_experts
        return (3 if self.mlp_gated else 2) * d * self.d_ff

    def _ssm_params(self) -> int:
        d, s = self.d_model, self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        ng = s.n_groups
        proj_out = 2 * di + 2 * ng * s.d_state + nh   # in_proj: z x B C dt
        p = d * proj_out
        p += s.d_conv * (di + 2 * ng * s.d_state)     # conv over x, B, C
        p += nh * 3                                    # A_log, D, dt_bias
        p += di                                        # gated rmsnorm
        p += di * d                                    # out_proj
        return p


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


def flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Rough forward FLOPs per token: 2 · active params + the attention
    (or SSD scan) term."""
    base = 2.0 * cfg.active_param_count()
    attn = 0.0
    for seg in cfg.segments:
        n = seg.n_layers * (2 if seg.kind == "attn_pair" else 1)
        if seg.kind == "ssm":
            s = cfg.ssm
            attn += n * 2.0 * s.d_inner(cfg.d_model) * s.d_state * 2
            continue
        window = seg.sliding_window or cfg.sliding_window or seq_len
        eff = min(window, seq_len)
        attn += n * 2.0 * 2 * cfg.n_heads * cfg.head_dim * eff / 2
    return base + attn


def config_fingerprint(cfg) -> str:
    """Stable identity string of a family config: the class name and every
    dataclass field (``ModelConfig`` and ``CNNConfig`` alike), the same
    string the reference's ``config_fingerprint`` gives, so a fleet
    checkpoint refuses a different architecture up front."""
    if dataclasses.is_dataclass(cfg):
        fields = ",".join(f"{f.name}={getattr(cfg, f.name)!r}"
                          for f in dataclasses.fields(cfg))
        return f"{type(cfg).__name__}({fields})"
    return repr(cfg)
