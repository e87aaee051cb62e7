"""Model/arch configuration system.

One `ModelConfig` describes any architecture in the assigned pool: dense
GQA transformers, MoE (incl. MLA), Mamba2 hybrids, xLSTM, enc-dec, and
modality-stub variants.  `reduced()` derives the CPU smoke-test config.

Input shapes (the assigned benchmark cells) are `ShapeSpec`s; `input_specs`
in launch/dryrun.py turns (config, shape) into ShapeDtypeStructs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared: int = 0  # shared (always-on) experts
    top_k: int = 1
    d_ff_expert: int = 0
    num_dense_layers: int = 0  # leading layers that stay dense (deepseek: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    group_size: int = 4096  # dispatch group (bounds one-hot memory)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64  # N
    head_dim: int = 64  # P
    expand: int = 2
    conv_kernel: int = 4
    num_groups: int = 2  # B/C groups (G)
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8  # one sLSTM per 8 blocks (7:1 mLSTM:sLSTM)
    proj_factor: float = 2.0  # mLSTM up-projection
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # positional / norm / activation details
    rope_theta: float = 500000.0
    rms_eps: float = 1e-6
    qk_norm: bool = False  # qwen3
    attn_bias: bool = False  # qwen2-style qkv bias (internvl2 backbone)
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # gemma2 local layers: 4096
    global_every: int = 0  # gemma2: every 2nd layer is global
    sandwich_norm: bool = False  # gemma2 pre+post norms
    act: str = "silu"  # silu | gelu
    tie_embeddings: bool = False
    norm_scale_offset: bool = False  # gemma RMSNorm (1 + w)
    pos_embedding: str = "rope"  # rope | learned (whisper)
    attn_scale: Optional[float] = None  # gemma2 query_pre_attn_scalar
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)

    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # hybrid (zamba2): shared attention block every k ssm layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper frames after conv stub
    max_target_positions: int = 448  # whisper learned pos table (decoder)

    # modality stub
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_prefix_tokens: int = 0  # vlm: patch embeddings prepended

    # MTP (deepseek): extra multi-token-prediction head(s); off in dry-run
    mtp_depth: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # ---- derived -------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attention_kind(self) -> str:
        if self.mla is not None:
            return "mla"
        return "gqa"

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind, len == n_layers (+ encoder handled apart)."""
        kinds: List[str] = []
        for i in range(self.n_layers):
            if self.family in ("dense", "vlm", "encdec"):
                if self.sliding_window and self.global_every:
                    kinds.append("attn_local" if i % self.global_every != self.global_every - 1 else "attn_global")
                else:
                    kinds.append("attn_global")
            elif self.family == "moe":
                nd = self.moe.num_dense_layers if self.moe else 0
                kinds.append("attn_dense" if i < nd else "attn_moe")
            elif self.family == "hybrid":
                kinds.append("mamba")
            elif self.family == "ssm":
                per = self.xlstm.slstm_every if self.xlstm else 8
                kinds.append("slstm" if i % per == per - 1 else "mlstm")
            else:
                raise ValueError(self.family)
        return kinds

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_count(self) -> Tuple[int, int]:
        """Returns (total_params, active_params) — differ only for MoE."""
        D, F, V, H, K, hd = (
            self.d_model, self.d_ff, self.vocab_size,
            self.n_heads, self.n_kv_heads, self.hd,
        )
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        kinds = self.layer_kinds()
        for kind in kinds:
            if kind.startswith("attn"):
                if self.mla is not None:
                    m = self.mla
                    a = (
                        D * m.q_lora_rank
                        + m.q_lora_rank * H * (m.nope_head_dim + m.rope_head_dim)
                        + D * (m.kv_lora_rank + m.rope_head_dim)
                        + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                        + H * m.v_head_dim * D
                    )
                else:
                    a = D * H * hd + 2 * D * K * hd + H * hd * D
                total += a
                active += a
                if kind == "attn_moe":
                    m = self.moe
                    fe = m.d_ff_expert
                    router = D * m.num_experts
                    experts = m.num_experts * 3 * D * fe
                    shared = m.num_shared * 3 * D * fe
                    total += router + experts + shared
                    active += router + m.top_k * 3 * D * fe + shared
                else:
                    total += 3 * D * F
                    active += 3 * D * F
            elif kind == "mamba":
                s = self.ssm
                d_in = s.expand * D
                nh = d_in // s.head_dim
                conv_dim = d_in + 2 * s.num_groups * s.state_dim
                a = (
                    D * (2 * d_in + 2 * s.num_groups * s.state_dim + nh)
                    + conv_dim * s.conv_kernel
                    + 3 * nh
                    + d_in
                    + d_in * D
                )
                total += a
                active += a
            elif kind == "mlstm":
                x = self.xlstm
                d_in = int(x.proj_factor * D)
                hd_in = d_in // self.n_heads
                # headwise (block-diagonal) q/k/v projections, xLSTM-style
                a = D * 2 * d_in + 3 * d_in * hd_in + 2 * d_in + d_in * D
                total += a
                active += a
            elif kind == "slstm":
                x = self.xlstm
                nh = self.n_heads
                hd_s = D // nh
                f = int(x.slstm_proj_factor * D)
                a = 4 * D * D + 4 * nh * hd_s * hd_s + 3 * D * f
                total += a
                active += a
        # hybrid shared attention block (one set of weights)
        if self.shared_attn_every:
            a = (2 * D) * H * hd + 2 * (2 * D) * K * hd + H * hd * D + 3 * D * self.d_ff
            total += a
            active += a
        # encoder
        if self.n_encoder_layers:
            per = 4 * D * D + 3 * D * F  # MHA + (gelu MLP ~2 mats) approx 3
            cross = 4 * D * D * self.n_layers  # decoder cross-attn
            total += self.n_encoder_layers * per + cross
            active += self.n_encoder_layers * per + cross
        return int(total), int(active)

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/features, tiny dims."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=16 if self.n_encoder_layers else self.encoder_seq,
            num_prefix_tokens=4 if self.frontend == "vision_stub" else 0,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, num_experts=8, top_k=2, d_ff_expert=64,
                num_dense_layers=min(self.moe.num_dense_layers, 1), group_size=64,
            )
        if self.mla:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32,
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, state_dim=16, head_dim=16, chunk=16)
        if self.xlstm:
            kw["xlstm"] = replace(self.xlstm, slstm_every=4)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 8
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}

# archs for which long_500k is applicable (sub-quadratic sequence mixing)
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")
