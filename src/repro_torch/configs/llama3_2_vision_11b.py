"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers. [hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision tower + projector are STUBS per the brief: ``input_specs``
provides post-projector patch embeddings (b, n_image_tokens, 4096). The
language backbone has a cross-attention layer every 5th layer (8 of 40),
matching the model card's interleave.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="mlp", cross_attn=True),
           LayerSpec(mixer="attn", ffn="mlp"),
           LayerSpec(mixer="attn", ffn="mlp"),
           LayerSpec(mixer="attn", ffn="mlp"),
           LayerSpec(mixer="attn", ffn="mlp"))


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128_256,
        period=_PERIOD,
        n_image_tokens=1024, rope_theta=500_000.0,
        tie_embeddings=False, attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD,
        n_image_tokens=16, rope_theta=500_000.0,
        tie_embeddings=False, vocab_pad_multiple=16,
    )
