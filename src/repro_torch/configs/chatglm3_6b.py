"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (half-dim) RoPE, GQA. [arXiv:2406.12793]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="mlp"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=65_024,
        period=_PERIOD,
        rope_fraction=0.5,  # ChatGLM rotates half of each head dim
        attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD, rope_fraction=0.5, vocab_pad_multiple=16,
    )
