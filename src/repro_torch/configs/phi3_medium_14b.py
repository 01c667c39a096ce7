"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE + SwiGLU + GQA. [arXiv:2404.14219]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="mlp"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab_size=100_352,
        period=_PERIOD, attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD, vocab_pad_multiple=16,
    )
