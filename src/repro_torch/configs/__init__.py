"""Architecture config registry: the port's counterpart of the JAX
package's `configs/__init__.py`.

Each ported architecture has a module exporting ``full()`` (the exact
published config) and ``smoke()`` (a reduced same-family variant used by
CPU tests), copied from the JAX package. ``ALIASES`` keeps the JAX
package's external spellings. Every LLM architecture of the JAX package
is here: dense, MoE, hybrid (Zamba2: Mamba2 and a shared attention
block), RWKV6, the vision-language Llama-3.2-Vision (gated
cross-attention onto stub patch embeddings) and the encoder-decoder
Whisper large-v3. Llama 3 405B, Mixtral 8x22B, Llama-4 Maverick and
Llama-3.2-Vision 90B do not fit one card at full size (the last runs
there at full width with fewer layers); their smoke configs run on the
CPU. ``ams-seg`` names the segmentation student, which is built by
`models.seg`, not here; asking for it raises ``ValueError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = (
    "gemma2_9b",
    "gemma_2b",
    "moonshot_v1_16b_a3b",
    "mixtral_8x22b",
    "llama3_405b",
    "llama4_maverick_400b_a17b",
    "zamba2_7b",
    "rwkv6_3b",
    "llama32_vision_90b",
    "whisper_large_v3",
)

# external spelling (--arch flag) -> module name
ALIASES = {
    "gemma2-9b": "gemma2_9b",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "whisper-large-v3": "whisper_large_v3",
    "gemma-2b": "gemma_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "rwkv6-3b": "rwkv6_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama3-405b": "llama3_405b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "ams-seg": "ams_seg",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).full()
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke()
    return cfg.replace(**overrides) if overrides else cfg
