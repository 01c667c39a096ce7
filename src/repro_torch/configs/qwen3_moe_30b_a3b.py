"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="moe"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151_936,
        period=_PERIOD,
        n_experts=128, top_k=8, d_ff_expert=768,
        attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512,
        period=_PERIOD,
        n_experts=4, top_k=2, d_ff_expert=64, vocab_pad_multiple=16, capacity_factor=16.0,
    )
