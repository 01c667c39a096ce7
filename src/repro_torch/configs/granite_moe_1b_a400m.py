"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="moe"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49_155,
        period=_PERIOD,
        n_experts=32, top_k=8, d_ff_expert=512,
        attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512,
        period=_PERIOD,
        n_experts=4, top_k=2, d_ff_expert=64, vocab_pad_multiple=16, capacity_factor=16.0,
    )
