"""whisper-large-v3 [audio]: 32L(enc)+32L(dec) d_model=1280 20H d_ff=5120
vocab=51866, encoder-decoder. [arXiv:2212.04356]

The mel-spectrogram + conv frontend is a STUB per the brief:
``input_specs`` feeds precomputed 1500-frame embeddings (b, 1500, 1280)
to the encoder; we implement the transformer backbone (bidirectional
encoder + causal decoder with cross-attention, learned positions).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(mixer="attn", ffn="mlp", cross_attn=True),)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab_size=51_866,
        period=_PERIOD,
        n_encoder_layers=32, encoder_seq=1500,
        pos_embedding="learned", act="gelu", glu=False,
        tie_embeddings=True, attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_PERIOD,
        n_encoder_layers=2, encoder_seq=16,
        pos_embedding="learned", act="gelu", glu=False,
        max_position_embeddings=2048, vocab_pad_multiple=16,
    )
