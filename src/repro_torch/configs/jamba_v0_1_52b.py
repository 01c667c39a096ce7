"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887]

Period of 8 layers (4 periods): attention at slot 3 (mid-period, matching
the Jamba block layout), Mamba elsewhere; MoE replaces the MLP on every
odd slot (e:2 spacing).
"""
from repro_torch.models.config import LayerSpec, ModelConfig


def _period(moe: bool):
    slots = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if (moe and i % 2 == 1) else "mlp"
        slots.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(slots)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65_536,
        period=_period(moe=True),
        n_experts=16, top_k=2, d_ff_expert=14336,
        pos_embedding="none",  # Jamba uses no positional encoding
        attn_chunk_q=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        period=_period(moe=True),
        n_experts=4, top_k=2, d_ff_expert=128,
        pos_embedding="none", vocab_pad_multiple=16, capacity_factor=16.0,
    )
