"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local(4096-window)+global alternating attention, attn/logit soft-capping,
post-block norms, GeGLU, embedding scaling. [arXiv:2408.00118]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn_local", ffn="mlp"),
           LayerSpec(mixer="attn", ffn="mlp"))


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256_000,
        period=_PERIOD,
        sliding_window=4096, attn_softcap=50.0, logit_softcap=30.0,
        post_block_norm=True, act="gelu", glu=True,
        scale_embeddings=True, attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD,
        sliding_window=16, attn_softcap=50.0, logit_softcap=30.0,
        post_block_norm=True, act="gelu", glu=True,
        scale_embeddings=True, vocab_pad_multiple=16,
    )
