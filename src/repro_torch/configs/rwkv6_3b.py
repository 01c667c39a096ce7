"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Finch — data-dependent decay. [arXiv:2404.05892]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="rwkv", ffn="rwkv_ffn"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab_size=65_536,
        period=_PERIOD,
        rwkv_head_size=64, pos_embedding="none",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD,
        rwkv_head_size=32, pos_embedding="none",
        tie_embeddings=False, vocab_pad_multiple=16,
    )
