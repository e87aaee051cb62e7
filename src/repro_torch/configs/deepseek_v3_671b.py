"""deepseek-v3-671b [moe]: MLA (compressed-latent KV, decoupled RoPE),
1 shared + 256 routed experts top-8, first 3 layers dense, MTP.
61L d_model=7168 128H d_ff_expert=2048 vocab=129280.
[arXiv:2412.19437; hf]

d_ff=18432 is the dense-layer/shared-path MLP width (DeepSeek-V3 config);
the assigned `d_ff=2048` is the per-expert width (`moe.d_ff_expert`)."""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=256,
        num_shared=1,
        top_k=8,
        d_ff_expert=2048,
        num_dense_layers=3,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    mtp_depth=1,
)
