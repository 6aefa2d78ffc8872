"""Llama 3.1 405B [arXiv:2407.21783] — dense, GQA kv=8, 126 layers."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    pattern=("attn",),
    mlp_act="swiglu",
    norm="rms",
    rope_theta=500_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128_256,
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
        d_ff=256,
        vocab_size=512,
        **_BASE,
    )
