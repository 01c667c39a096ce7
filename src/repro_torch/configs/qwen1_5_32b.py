"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B scaled per assignment]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="mlp"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152_064,
        period=_PERIOD, qkv_bias=True,
        attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD, qkv_bias=True, vocab_pad_multiple=16,
    )
