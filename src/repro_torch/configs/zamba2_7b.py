"""Zamba2-7B [arXiv:2411.15242] — hybrid: Mamba2 trunk + shared attention
block applied periodically (weights reused; here: at the start of each
3-mamba-layer scan group, 27 applications over 81 layers)."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    pattern=("mamba", "mamba", "mamba"),
    shared_attn=True,
    mlp_act="swiglu",
    norm="rms",
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_chunk=128,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        **_BASE,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_chunk=8,
        **dict(_BASE, ssm_head_dim=32),
    )
