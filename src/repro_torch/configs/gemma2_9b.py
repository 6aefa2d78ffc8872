"""Gemma-2 9B [arXiv:2408.00118] — dense, local+global alternating attention,
GeGLU, logit softcaps, post-block norms, GQA kv=8, head_dim=256."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    pattern=("attn_local", "attn"),
    window_size=4096,
    mlp_act="geglu",
    norm="rms",
    post_norm=True,
    embed_scale=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
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
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        **dict(_BASE, window_size=16),
    )
