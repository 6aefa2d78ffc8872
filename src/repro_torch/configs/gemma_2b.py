"""Gemma 2B [arXiv:2403.08295] — dense, GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295",
    pattern=("attn",),
    mlp_act="geglu",
    norm="rms",
    embed_scale=True,
    rope_theta=10_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
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
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        **_BASE,
    )
