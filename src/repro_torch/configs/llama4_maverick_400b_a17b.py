"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] —
alternating dense/MoE layers, 128 routed experts top-1 + shared expert."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    pattern=("attn", "moe"),
    mlp_act="swiglu",
    norm="rms",
    rope_theta=500_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        num_experts=128,
        experts_per_token=1,
        expert_d_ff=8192,
        num_shared_experts=1,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        **_BASE,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        experts_per_token=1,
        expert_d_ff=128,
        num_shared_experts=1,
        **_BASE,
    )
