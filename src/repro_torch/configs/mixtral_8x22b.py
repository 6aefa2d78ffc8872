"""Mixtral 8x22B [arXiv:2401.04088] — 8 experts top-2, sliding-window
attention (per assignment), GQA kv=8."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    pattern=("moe_local",),
    window_size=4096,
    mlp_act="swiglu",
    norm="rms",
    rope_theta=1_000_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        experts_per_token=2,
        expert_d_ff=16384,
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
        experts_per_token=2,
        expert_d_ff=128,
        **dict(_BASE, window_size=16),
    )
