"""PyTorch port: prefill (flash) attention against the JAX package.

On CPU tensors ``flash_attention`` runs its plain version, which must
agree with JAX's Pallas kernel (interpret mode, through its GQA wrapper
``ops.flash_attention(use_kernel=True)``) and with its dense oracle
(``use_kernel=False``) on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: 2e-5 in f32 (3e-5 for the property sweep and
the model cross-check), 2e-2 in bf16. The masking cases include a
window (64) narrower than the kernel's key tile (128), where rows meet a
wholly masked tile before their first visible key. The CUDA kernel is
held to the plain version on the card (test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ops import flash_attention as jflash  # noqa: E402
from repro_torch.kernels.flash_attn import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(b, sq, skv, h, kvh, dh, seed=0):
    """test_kernels._qkv's inputs (normal * 0.5) as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, sq, h, dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, skv, kvh, dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, skv, kvh, dh)) * 0.5).astype(np.float32)
    return q, k, v


def _both(arrays, dtype, **kw):
    """(port plain, JAX Pallas interpret, JAX oracle) as f32 numpy."""
    jdt, tdt, _ = DTYPES[dtype]
    n0 = tops.flash_attention.launches
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in arrays), **kw)
    assert tops.flash_attention.launches == n0       # CPU: never a launch
    assert got.dtype == tdt and got.shape == arrays[0].shape
    ja = [jnp.asarray(a, jdt) for a in arrays]
    pallas = jflash(*ja, use_kernel=True, interpret=True, **kw)
    oracle = jflash(*ja, use_kernel=False, **{k: v for k, v in kw.items()
                                              if k not in ("block_q",
                                                           "block_k")})
    return (got.float().numpy(), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq,skv,dh", [(128, 128, 64), (256, 384, 128),
                                       (128, 160, 32)])
def test_plain_matches_jax_shapes_dtypes(sq, skv, dh, dtype):
    got, pallas, oracle = _both(_qkv(2, sq, skv, 4, 4, dh), dtype,
                                causal=False, block_q=128, block_k=128)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None),
    (True, 64, None),        # gemma2 sliding window, narrower than a tile
    (True, None, 50.0),      # gemma2 attn softcap
    (True, 64, 50.0),
    (False, 64, None),       # two-sided band
], ids=["causal", "window64", "softcap", "window64_softcap",
        "noncausal_window64"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_masking_variants(causal, window, softcap, dtype):
    got, pallas, oracle = _both(_qkv(1, 256, 256, 2, 2, 64, seed=7), dtype,
                                causal=causal, window=window,
                                softcap=softcap)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("h,kvh", [(8, 2), (8, 4), (4, 1)])
def test_plain_gqa_groups(h, kvh):
    """Query head h reads KV head h // (h / kv_heads)."""
    got, pallas, oracle = _both(_qkv(2, 128, 128, h, kvh, 64, seed=9),
                                "float32", causal=True)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


def test_plain_matches_the_ports_chunked_sdpa():
    """Cross-check against the model's own attention (an independent
    implementation): ``layers._sdpa_chunked`` at 3e-5."""
    from repro_torch.models.layers import _sdpa_chunked

    b, s, h, kvh, dh = 2, 256, 4, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, s, h, kvh, dh,
                                                  seed=11))
    pos = torch.arange(s).expand(b, s)
    for window, softcap in ((None, None), (64, 50.0)):
        want = _sdpa_chunked(q, k, v, q_positions=pos, kv_positions=pos,
                             chunk=64, causal=True, window=window,
                             softcap_val=softcap)
        got = tops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=softcap)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5,
                                   rtol=3e-5)


def test_attention_ref_is_the_jax_oracle_on_the_flat_layout():
    from repro.kernels.flash_attn.ref import attention_ref as jref

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(3, 96, 32)).astype(np.float32)
               for _ in range(3))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True, window=40, softcap=30.0)
    want = jref(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                window=40, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_wrapper_refuses_what_jax_asserts_and_rows_without_keys():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, 2, 2, 32))
    with pytest.raises(ValueError):               # sq % block_q
        tops.flash_attention(q, k, v, block_q=96)
    with pytest.raises(ValueError):               # h % kv_heads
        tops.flash_attention(q, k[:, :, :1].expand(1, 128, 3, 32).clone(),
                             v[:, :, :1].expand(1, 128, 3, 32).clone())
    with pytest.raises(ValueError):               # window < 1
        tops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):               # rows past window + skv
        tops.flash_attention(q, k[:, :16], v[:, :16], window=8)


@given(seed=st.integers(0, 10_000),
       sq=st.sampled_from([128, 256]),
       skv=st.sampled_from([128, 192, 320]),
       causal=st.booleans())
@settings(max_examples=15, deadline=None)
def test_plain_property_sweep(seed, sq, skv, causal):
    if causal and sq > skv:
        skv = sq   # causal rows must see a key (test_kernels' harness)
    got, pallas, oracle = _both(_qkv(1, sq, skv, 2, 1, 64, seed=seed),
                                "float32", causal=causal)
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5, rtol=3e-5)
