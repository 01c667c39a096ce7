"""Architecture registry of the port: ``--arch <id>``, the JAX
package's ten architectures (one module each, copied)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["gemma2_2b", "qwen1_5_32b", "phi3_medium_14b", "chatglm3_6b",
            "granite_moe_1b_a400m", "qwen3_moe_30b_a3b", "jamba_v0_1_52b",
            "rwkv6_3b", "whisper_large_v3", "llama3_2_vision_11b"]

# public ids (with dashes/dots) -> module name
ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-32b": "qwen1_5_32b",
    "phi3-medium-14b": "phi3_medium_14b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    """The full config of every arch, by public id."""
    return {a: get_config(a) for a in sorted(ALIASES)}
