"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder; the mel+conv
frontend is a stub (input_specs feeds 1500 frame embeddings). Deviation
(DESIGN.md §8): sinusoidal positions for both stacks instead of a learned
decoder table (a 500k-row learned table is not meaningful)."""
from repro_torch.models.common import ModelConfig

_BASE = dict(
    name="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    pattern=("attn_xattn",),
    mlp_act="gelu",
    norm="layer",
    pos="sinusoidal",
)


def full() -> ModelConfig:
    return ModelConfig(
        num_layers=32,
        encoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        num_xattn_tokens=1500,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat=True,
        **_BASE,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_xattn_tokens=24,
        **_BASE,
    )
