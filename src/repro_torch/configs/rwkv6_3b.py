"""RWKV-6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dependent
decay time-mix; head_size 64 (40 heads at d_model 2560)."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    pattern=("rwkv",),
    mlp_act="gelu",  # unused by rwkv blocks; channel-mix has its own form
    norm="layer",
    pos="none",
    ssm_head_dim=64,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=32,
        d_model=2560,
        num_heads=1,
        num_kv_heads=1,
        d_ff=8960,
        vocab_size=65536,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        **_BASE,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        num_layers=2,
        d_model=128,
        num_heads=1,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        **dict(_BASE, ssm_head_dim=32),
    )
