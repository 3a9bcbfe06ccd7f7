"""Config system: architecture configs, shape specs, and the registry.

Every assigned architecture gets one module in this package defining a
``ModelConfig``; ``registry.get(arch_id)`` returns it. Reduced ("smoke")
variants are derived mechanically via ``ModelConfig.reduced()`` so smoke
tests always exercise the same code path as the full config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 0
    num_shared_experts: int = 0     # DeepSeek-style always-on experts
    dense_residual: bool = False    # Arctic-style dense FFN in parallel w/ MoE
    expert_d_ff: int = 0            # per-expert hidden size
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    capacity_factor: float = 1.25   # EP dispatch capacity (dropless if <=0)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0              # N (SSD state size)
    head_dim: int = 64              # P (SSD head dim)
    num_heads: int = 0              # d_inner / head_dim; 0 = derive
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 128           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int               # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 = d_model // num_heads
    # encoder-decoder
    num_encoder_layers: int = 0
    # mixture of experts
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1       # every k-th layer is MoE (1 = all)
    # state-space
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): one shared attention block applied every k SSM layers
    hybrid_attn_period: int = 0     # 0 = not hybrid
    # attention details
    rope_theta: float = 10_000.0
    mrope: bool = False             # Qwen2-VL multimodal rope (t/h/w sections)
    sliding_window: int = 0         # 0 = full attention
    # norms / activations
    mlp_type: str = "swiglu"        # swiglu | gelu (non-gated)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontend stub: tokens replaced by precomputed embeddings
    frontend: str = "none"          # none | audio_frames | vision_patches
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_to: int = 256         # pad embedding tables for TP divisibility
    # training
    remat: bool = True              # activation checkpointing per layer
    # citation provenance
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches models.model init; used for 6ND)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads

        def attn_params() -> int:
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d

        def dense_ffn(width: int) -> int:
            # SwiGLU: gate+up+down; non-gated: up+down
            return (3 if self.mlp_type == "swiglu" else 2) * d * width

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nh = s.num_heads or d_in // s.head_dim
            # in_proj(z,x,B,C,dt) + conv + A,D + norm + out_proj
            in_p = d * (2 * d_in + 2 * s.state_dim * 1 + nh)
            conv = (d_in + 2 * s.state_dim) * s.conv_width
            return in_p + conv + 2 * nh + d_in + d_in * d

        per_layer = 0
        n_dec = self.num_layers
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_params() + dense_ffn(dff) + 2 * d
            body = per_layer * n_dec
        elif self.family == "moe":
            m = self.moe
            moe_ffn = (m.num_experts + m.num_shared_experts) * 3 * d * m.expert_d_ff
            moe_ffn += d * m.num_experts  # router
            if m.dense_residual:
                moe_ffn += dense_ffn(dff)
            n_moe = n_dec // self.moe_layer_period
            n_plain = n_dec - n_moe
            body = n_moe * (attn_params() + moe_ffn + 2 * d)
            body += n_plain * (attn_params() + dense_ffn(dff) + 2 * d)
        elif self.family == "ssm":
            body = n_dec * (ssm_params() + d)
        elif self.family == "hybrid":
            body = n_dec * (ssm_params() + d)
            # one SHARED attention+ffn block (weights reused at each period)
            body += attn_params() + dense_ffn(dff) + 2 * d
        elif self.family == "encdec":
            enc_layer = attn_params() + dense_ffn(dff) + 2 * d
            dec_layer = 2 * attn_params() + dense_ffn(dff) + 3 * d  # self+cross
            body = self.num_encoder_layers * enc_layer + n_dec * dec_layer
        else:
            raise ValueError(self.family)

        embed = V * d
        head = 0 if self.tie_embeddings else V * d
        return body + embed + head + d  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        total = self.param_count()
        all_experts = m.num_experts * 3 * d * m.expert_d_ff
        active_experts = m.top_k * 3 * d * m.expert_d_ff
        n_moe = self.num_layers // self.moe_layer_period
        return total - n_moe * (all_experts - active_experts)

    def tp_pad_heads(self, tp: int) -> "ModelConfig":
        """Pad query-head count up to a multiple of the TP degree (Megatron
        practice). Padded heads are architecturally inert at init (zero
        o-proj rows) and exist purely so the head dim shards cleanly —
        28→32 (qwen2-vl), 56→64 (arctic) at tp=16. GQA divisibility
        (Hq % Hkv == 0) is preserved by construction for the assigned archs."""
        if not self.num_heads or self.num_heads % tp == 0:
            return self
        padded = ((self.num_heads + tp - 1) // tp) * tp
        hd = self.resolved_head_dim
        return dataclasses.replace(self, num_heads=padded, head_dim=hd)

    # ---- reduced config for smoke tests -------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16 if self.num_heads else 0,
            num_encoder_layers=2 if self.num_encoder_layers else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, num_heads=0, chunk_size=32)
        if self.hybrid_attn_period:
            kw["hybrid_attn_period"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 32
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
LONG_CONTEXT_ARCHS = ("mamba2-130m", "zamba2-7b")


def cell_is_runnable(arch_id: str, shape_name: str) -> bool:
    """Whether (arch, shape) is a runnable dry-run cell (else documented skip)."""
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    # import every config module once (registers itself)
    from repro_torch.configs import (  # noqa: F401
        seamless_m4t_medium, arctic_480b, deepseek_moe_16b, zamba2_7b,
        yi_9b, starcoder2_15b, llama3_405b, stablelm_1_6b, qwen2_vl_7b,
        mamba2_130m)
    _LOADED = True
