"""PyTorch port: the fused SDM-DSGD update against the JAX package.

On CPU tensors ``sdm_update_planes`` runs its plain version, which must
agree with JAX's oracle ``ref.sdm_update_ref`` and with its Pallas kernel
``sdm_update_pallas`` in interpret mode on the same numpy inputs, at the
tolerance of ``tests/test_kernels.py`` (rtol/atol 1e-6; 1e-5 for the
property sweep). The tree wrapper ``sdm_update`` draws its bits with the
port's threefry and must match JAX's ``ops.sdm_update(use_kernel=False)``
under the same key. The CUDA kernel is held to the plain version on the
card (test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sdm_update import ops as jops  # noqa: E402
from repro.kernels.sdm_update import ref as jref  # noqa: E402
from repro.kernels.sdm_update.sdm_update import sdm_update_pallas  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.plane import ParamPlane  # noqa: E402
from repro_torch.kernels import sdm_update as tsu  # noqa: E402

LANE = 1024
SDM_KW = dict(p=0.25, theta=0.4, gamma=0.05, sigma=0.7, clip_c=1.5,
              self_w=1.0 / 3.0)


def _operands(rows, seed=0):
    """test_kernels._operands: 4 normal f32 planes, 3 u32 bit planes."""
    rng = np.random.default_rng(seed)
    shape = (rows, LANE)
    f = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    bits = [rng.integers(0, 2**32, size=shape, dtype=np.uint32)
            for _ in range(3)]
    return f, bits


def _port(f, bits, as_int64=False, **kw):
    """The port's plain path on CPU tensors; bits as int32 storage (the
    kernel's) or as int64 u32 words (``prng.bits``')."""
    words = [torch.from_numpy(b.astype(np.int64)) if as_int64
             else torch.from_numpy(b.view(np.int32)) for b in bits]
    n0 = tsu.sdm_update_planes.launches
    out = tsu.sdm_update_planes(*(torch.from_numpy(a) for a in f), *words,
                                **kw)
    assert tsu.sdm_update_planes.launches == n0     # CPU: never a launch
    return [o.numpy() for o in out]


def _jax(f, bits, block_rows, **kw):
    ops = [jnp.asarray(a) for a in f] + [jnp.asarray(b) for b in bits]
    want_ref = jref.sdm_update_ref(*ops, **kw)
    want_pallas = sdm_update_pallas(*ops, block_rows=block_rows,
                                    interpret=True, **kw)
    return ([np.asarray(a) for a in want_ref],
            [np.asarray(a) for a in want_pallas])


def _close(got, want, tol):
    for a, b, name in zip(got, want, ("x_new", "s_new", "sd")):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("rows,block_rows", [(8, 8), (16, 8), (64, 32)])
def test_plain_matches_jax_oracle_and_pallas(rows, block_rows):
    f, bits = _operands(rows)
    got = _port(f, bits, block_rows=block_rows, **SDM_KW)
    want_ref, want_pallas = _jax(f, bits, block_rows, **SDM_KW)
    _close(got, want_ref, 1e-6)
    _close(got, want_pallas, 1e-6)


@pytest.mark.parametrize("kw", [
    dict(SDM_KW, sigma=0.0),            # no noise branch
    dict(SDM_KW, clip_c=None),          # no clip branch
    dict(SDM_KW, p=1.0),                # no sparsification
    dict(SDM_KW, theta=1.0),            # DC-DSGD corner
], ids=["sigma0", "no_clip", "p1", "theta1"])
def test_plain_branch_configs(kw):
    f, bits = _operands(8, seed=3)
    got = _port(f, bits, block_rows=8, **kw)
    want_ref, want_pallas = _jax(f, bits, 8, **kw)
    _close(got, want_ref, 1e-6)
    _close(got, want_pallas, 1e-6)


def test_bit_words_above_2_31_give_the_unsigned_uniform():
    """Words >= 2^31 (negative as int32) must read as their unsigned top
    24 bits: an arithmetic shift of the int32 view would turn them into
    negative uniforms, always below p and with a NaN log."""
    f, _ = _operands(8, seed=11)
    rng = np.random.default_rng(12)
    high = [rng.integers(2**31, 2**32, size=(8, LANE), dtype=np.uint32)
            for _ in range(3)]
    high[0][0, :4] = [2**31, 2**32 - 1, 2**31 + 255, 2**31 + 256]
    u = tsu.uniform01(torch.from_numpy(high[0].view(np.int32))).numpy()
    want_u = np.maximum((high[0] >> 8).astype(np.float32) * 2.0**-24,
                        2.0**-24)
    assert np.array_equal(u, want_u) and u.min() >= 0.5
    got32 = _port(f, high, block_rows=8, **SDM_KW)
    got64 = _port(f, high, as_int64=True, block_rows=8, **SDM_KW)
    for a, b in zip(got32, got64):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    want_ref, want_pallas = _jax(f, high, 8, **SDM_KW)
    _close(got32, want_ref, 1e-6)
    _close(got32, want_pallas, 1e-6)
    assert all(np.isfinite(a).all() for a in got32)


def test_u32_words_round_trip():
    b = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    w = tsu.u32_words(b)
    assert w.dtype == torch.int32
    assert np.array_equal(w.numpy().view(np.uint32),
                          b.numpy().astype(np.uint32))


def test_plain_rejects_what_the_kernel_does_not_take():
    f, bits = _operands(8)
    t = [torch.from_numpy(a) for a in f] + \
        [torch.from_numpy(b.view(np.int32)) for b in bits]
    with pytest.raises(ValueError):        # rows % block_rows
        tsu.sdm_update_planes(*t, block_rows=16, **SDM_KW)
    with pytest.raises(ValueError):        # lane width
        tsu.sdm_update_planes(*(v.reshape(16, 512) for v in t), block_rows=8,
                              **SDM_KW)
    with pytest.raises(ValueError):        # uint32 streams (no CPU shift)
        tsu.uniform01(torch.zeros(4, dtype=torch.uint32))


@given(seed=st.integers(0, 2**31 - 1),
       p=st.sampled_from([0.1, 0.5, 1.0]),
       theta=st.floats(0.05, 1.0),
       sigma=st.sampled_from([0.0, 0.5]))
@settings(max_examples=25, deadline=None)
def test_plain_property_sweep(seed, p, theta, sigma):
    f, bits = _operands(8, seed=seed % 1000)
    kw = dict(p=p, theta=theta, gamma=0.01, sigma=sigma, clip_c=2.0,
              self_w=0.5)
    got = _port(f, bits, block_rows=8, **kw)
    want_ref, want_pallas = _jax(f, bits, 8, **kw)
    _close(got, want_ref, 1e-5)
    _close(got, want_pallas, 1e-5)


def test_plane_layout_matches_jax():
    """``ParamPlane.for_tree(lane=1024, row_multiple=)``: the kernel
    layout of the JAX package, rows padded to the tile multiple."""
    from repro.core.plane import ParamPlane as JPlane

    shapes = {"a": (3, 5), "b": (7,), "c": (40, 33)}
    for rm in (1, 8, 32):
        tp = ParamPlane.for_tree(
            {k: torch.zeros(s) for k, s in shapes.items()}, lane=LANE,
            row_multiple=rm, buckets=None)
        jp = JPlane.for_tree({k: jnp.zeros(s) for k, s in shapes.items()},
                             lane=LANE, row_multiple=rm, buckets=None)
        assert tp.plane_shapes() == jp.plane_shapes()
        assert tp.total_size == jp.total_size
        assert tp.padded_size == jp.padded_size
    # the default layout is unchanged, and the cache keys on the layout
    default = ParamPlane.for_tree({"a": torch.zeros(300)})
    wide = ParamPlane.for_tree({"a": torch.zeros(300)}, lane=LANE,
                               row_multiple=8)
    assert default.plane_shapes() == ((3, 128),)
    assert wide.plane_shapes() == ((8, LANE),)
    assert default is ParamPlane.for_tree({"a": torch.zeros(300)})


@pytest.mark.parametrize("block_rows", [8, 32])
@pytest.mark.parametrize("sigma", [0.0, 0.7])
def test_tree_wrapper_matches_jax_with_the_same_key(block_rows, sigma):
    rng = np.random.default_rng(7)
    shapes = {"conv": (3, 3, 4, 8), "bias": (8,), "dense": (300, 10)}
    trees = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    kw = dict(SDM_KW, sigma=sigma)
    got = tsu.sdm_update(*({k: torch.from_numpy(v) for k, v in t.items()}
                           for t in trees), prng.PRNGKey(3),
                         block_rows=block_rows, **kw)
    want = jops.sdm_update(*({k: jnp.asarray(v) for k, v in t.items()}
                             for t in trees), jax.random.PRNGKey(3),
                           use_kernel=False, **kw)
    for g_tree, w_tree in zip(got, want):
        assert set(g_tree) == set(w_tree)
        for name in g_tree:
            np.testing.assert_allclose(g_tree[name].numpy(),
                                       np.asarray(w_tree[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)


def test_tree_wrapper_draws_do_not_depend_on_the_tiling():
    rng = np.random.default_rng(8)
    tree = {"w": torch.from_numpy(rng.normal(size=(5000,)).astype(
        np.float32))}
    zeros = {"w": torch.zeros(5000)}
    a = tsu.sdm_update(tree, zeros, zeros, tree, prng.PRNGKey(1),
                       block_rows=8, **SDM_KW)
    b = tsu.sdm_update(tree, zeros, zeros, tree, prng.PRNGKey(1),
                       block_rows=32, **SDM_KW)
    for ta, tb in zip(a, b):
        assert torch.equal(ta["w"], tb["w"])
