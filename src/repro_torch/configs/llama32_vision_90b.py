"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled per
assignment] — 100 layers with gated cross-attention image layers every 5th;
vision encoder is a stub (input_specs feeds patch embeddings)."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    mlp_act="swiglu",
    norm="rms",
    rope_theta=500_000.0,
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128_256,
        num_xattn_tokens=1601,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        **_BASE,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        num_layers=5,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_xattn_tokens=24,
        **_BASE,
    )
