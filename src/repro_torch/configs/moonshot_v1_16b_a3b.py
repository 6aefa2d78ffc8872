"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] — fine-grained MoE
(DeepSeek-style): 64 routed experts top-6 + 2 shared experts, expert
d_ff=1408."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="moonshot-v1-16b-a3b",
    family="dense",  # per assignment table label; structurally MoE
    source="hf:moonshotai/Moonlight-16B-A3B",
    pattern=("moe",),
    mlp_act="swiglu",
    norm="rms",
    rope_theta=50_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163_840,
        num_experts=64,
        experts_per_token=6,
        expert_d_ff=1408,
        num_shared_experts=2,
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
        num_kv_heads=4,
        head_dim=32,
        d_ff=64,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
        expert_d_ff=64,
        num_shared_experts=1,
        **_BASE,
    )
