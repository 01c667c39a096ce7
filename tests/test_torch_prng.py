"""PyTorch port: ``repro_torch.prng`` against ``jax.random``.

The same keys go through both. ``bits``, ``uniform``, ``bernoulli``,
``split``, ``fold_in`` and the fixed-k index draw must be bit-exact;
``normal`` differs only through ``erfinv``: XLA's f32 inverse error
function is a polynomial the port repeats, over ``log1p`` whose last bit
differs between the two libraries. Measured on 10^6 draws: 95 % equal,
at most 3 ulp apart; the test allows 4 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsifier as jsparsifier  # noqa: E402
from repro_torch import prng  # noqa: E402

NORMAL_ULPS = 4


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -7])
def test_prngkey_matches(seed):
    assert np.array_equal(_np(_jkey(seed)), prng.PRNGKey(seed).numpy())


def test_split_and_fold_in_bit_exact():
    jk, tk = _jkey(7), prng.PRNGKey(7)
    for num in (2, 3, 64):
        assert np.array_equal(_np(jax.random.split(jk, num)),
                              prng.split(tk, num).numpy())
    for data in (0, 1, 123, 2 ** 31 - 1, 0x5eed):
        assert np.array_equal(_np(jax.random.fold_in(jk, data)),
                              prng.fold_in(tk, data).numpy())
    # batched: a vector of node indices folds into one key each (vmap)
    jb = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(9))
    tb = prng.fold_in(tk, torch.arange(9))
    assert np.array_equal(_np(jb), tb.numpy())
    assert np.array_equal(_np(jax.vmap(jax.random.split)(jb)),
                          prng.split(tb).numpy())
    # the trainer's chain: split per step, then (k_sp, k_noise)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
    assert np.array_equal(_np(jax.random.split(jsub)),
                          prng.split(tsub).numpy())


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 1001), (4, 5, 128)])
def test_bits_and_uniform_bit_exact(shape):
    jk, tk = _jkey(11), prng.PRNGKey(11)
    jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(jb, prng.bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = prng.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32 and np.array_equal(ju, tu)
    lo, hi = -2.5, 0.75
    assert np.array_equal(
        np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi)),
        prng.uniform(tk, shape, lo, hi).numpy())


def test_batched_uniform_equals_vmap():
    base = _jkey(3)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(6))
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 128)))(keys))
    tkeys = prng.fold_in(prng.PRNGKey(3), torch.arange(6))
    assert np.array_equal(ju, prng.uniform(tkeys, (9, 128)).numpy())


@pytest.mark.parametrize("p", [0.2, 0.5, 0.999])
def test_bernoulli_bit_exact(p):
    jk, tk = _jkey(5), prng.PRNGKey(5)
    assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, (33, 40))),
                          prng.bernoulli(tk, p, (33, 40)).numpy())


def test_normal_within_stated_ulps():
    jk, tk = _jkey(9), prng.PRNGKey(9)
    n = 200_000
    jn = np.asarray(jax.random.normal(jk, (n,)))
    tn = prng.normal(tk, (n,)).numpy()
    ulp = np.spacing(np.abs(jn).astype(np.float32))
    gap = np.abs(jn - tn) / ulp
    assert gap.max() <= NORMAL_ULPS, gap.max()
    assert (gap == 0).mean() > 0.9


@pytest.mark.parametrize("d,k", [(100, 20), (2128, 426), (5000, 1)])
def test_fixedk_indices_bit_exact(d, k):
    for seed in range(3):
        ji = np.asarray(jsparsifier.fixedk_indices(_jkey(seed), d, k))
        ti = prng.fixedk_indices(prng.PRNGKey(seed), d, k).numpy()
        assert np.array_equal(ji, ti)


def test_top_k_tie_order_matches_lax():
    # a tie-heavy score vector: 5 distinct values over 4000 entries
    scores = np.random.default_rng(0).integers(0, 5, 4000).astype(np.float32)
    for k in (1, 17, 800, 3999):
        _, ji = jax.lax.top_k(jnp.asarray(scores), k)
        ti = prng.top_k_indices(torch.from_numpy(scores), k)
        assert np.array_equal(np.asarray(ji), ti.numpy())
    # a real draw at ResNet-20's plane size: f32 uniforms carry 23 bits,
    # so thousands of scores tie
    jk = _jkey(1)
    u = np.asarray(jax.random.uniform(jk, (272_384,)))
    assert len(u) - len(np.unique(u)) > 1000
    _, ji = jax.lax.top_k(jnp.asarray(u), 54_477)
    ti = prng.fixedk_indices(prng.PRNGKey(1), 272_384, 54_477)
    assert np.array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_draws_are_the_same_bits(monkeypatch, chunk):
    """Draws over more than ``prng._CHUNK`` counters run in counter-aligned
    chunks (bounded int64 temporaries at full width); the bits, the
    uniforms and the normals do not depend on the chunking, for one key
    and for a batch of keys, and stay bit-exact with jax.random."""
    keys = prng.fold_in(prng.PRNGKey(3), torch.arange(3))        # (3, 2)
    shape = (5, 41)
    whole = (prng.bits(keys, shape), prng.uniform(keys, shape),
             prng.normal(keys, shape), prng.normal(keys, shape,
                                                   dtype=torch.bfloat16))
    monkeypatch.setattr(prng, "_CHUNK", chunk)
    parts = (prng.bits(keys, shape), prng.uniform(keys, shape),
             prng.normal(keys, shape), prng.normal(keys, shape,
                                                   dtype=torch.bfloat16))
    for a, b in zip(whole, parts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert whole[3].dtype == torch.bfloat16 and torch.equal(
        whole[3], whole[2].to(torch.bfloat16))
    jk = jax.random.fold_in(_jkey(3), 1)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          parts[1][1].numpy())
