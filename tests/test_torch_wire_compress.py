"""PyTorch port: the plain qsgd_pack against the JAX wire_compress kernel.

The same values, uniforms and norms go through the JAX ``qsgd_pack``
(its Pallas kernel in interpret mode for lane-aligned planes, its jnp
oracle otherwise, as the JAX package's own tests run them) and through
the port's ``qsgd_pack`` on CPU tensors, which runs the plain version
``qsgd_quantize_pack_ref``. The byte images must be equal, and so must
the decoded values. The CUDA kernel is held against the plain version on
the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import wire_compress as jwc  # noqa: E402
from repro_torch.kernels import wire_compress as twc  # noqa: E402


def _inputs(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    u = rng.random(size=shape).astype(np.float32)
    return x, u


def _jax_pack(x, u, norm, bits):
    return np.asarray(jwc.qsgd_pack(jnp.asarray(x), jnp.asarray(u),
                                    jnp.asarray(norm), bits=bits,
                                    interpret=True))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(16, 128), (9, 128), (1001,), (3, 7, 5)])
def test_plain_pack_equals_jax_kernel(bits, shape):
    x, u = _inputs(shape, seed=bits)
    norm = np.float32(np.sqrt((x.astype(np.float64) ** 2).sum()))
    want = _jax_pack(x, u, norm, bits)
    n0 = twc.qsgd_pack.launches
    got = twc.qsgd_pack(torch.from_numpy(x), torch.from_numpy(u),
                        torch.tensor(norm), bits=bits)
    assert twc.qsgd_pack.launches == n0      # CPU: the plain version
    assert got.dtype == torch.uint8
    assert np.array_equal(want, got.numpy())
    k = twc.pack_factor(bits)
    assert got.shape == (-(-x.size // k),)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_zero_plane_and_signed_zeros(bits):
    s = twc.levels(bits)
    x = np.zeros((8, 128), np.float32)
    u = np.random.default_rng(0).random((8, 128)).astype(np.float32)
    want = _jax_pack(x, u, np.float32(0.0), bits)
    got = twc.qsgd_pack(torch.from_numpy(x), torch.from_numpy(u),
                        torch.tensor(0.0), bits=bits).numpy()
    assert np.array_equal(want, got)
    # every level is 0 -> every field encodes s
    k = twc.pack_factor(bits)
    assert np.all(got == sum(s << (j * bits) for j in range(k)))
    x2, u2 = _inputs((8, 128), seed=9)
    x2[:, ::3] = -0.0
    x2[:, 1::7] = 0.0
    norm = np.float32(np.sqrt((x2.astype(np.float64) ** 2).sum()))
    assert np.array_equal(
        _jax_pack(x2, u2, norm, bits),
        twc.qsgd_pack(torch.from_numpy(x2), torch.from_numpy(u2),
                      torch.tensor(norm), bits=bits).numpy())


def test_uniform_at_carry_threshold():
    """u == frac exactly: the carry's strict '<' keeps the floor."""
    bits = 4
    x, u = _inputs((16, 128), seed=3)
    norm = np.float32(np.sqrt((x.astype(np.float64) ** 2).sum()))
    inv = np.float32(7.0) / np.maximum(norm, np.float32(1e-30))
    ratio = np.abs(x) * inv
    u[::2] = (ratio - np.floor(ratio))[::2]
    assert np.array_equal(
        _jax_pack(x, u, norm, bits),
        twc.qsgd_pack(torch.from_numpy(x), torch.from_numpy(u),
                      torch.tensor(norm), bits=bits).numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stacked_pack_equals_per_node_jax(bits):
    """One call over a node stack (per-node norms) == the JAX kernel
    vmapped over the nodes."""
    n = 5
    x, u = _inputs((n, 9, 128), seed=11, scale=0.01)
    norms = np.sqrt((x.astype(np.float64) ** 2).reshape(n, -1).sum(-1)
                    ).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b, c: jwc.qsgd_pack(
        a, b, c, bits=bits, interpret=True))(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(norms)))
    got = twc.qsgd_pack(torch.from_numpy(x), torch.from_numpy(u),
                        torch.from_numpy(norms), bits=bits)
    assert got.shape == (n, want.shape[1])
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(9, 128), (1001,)])
def test_decode_bit_equal(bits, shape):
    x, u = _inputs(shape, seed=5)
    norm = np.float32(np.sqrt((x.astype(np.float64) ** 2).sum()))
    data = _jax_pack(x, u, norm, bits)
    buf = np.concatenate([data, np.frombuffer(norm.tobytes(), np.uint8)])
    want = np.asarray(jwc.qsgd_decode_ref(jnp.asarray(buf), shape,
                                          bits=bits))
    got = twc.qsgd_decode_ref(torch.from_numpy(buf.copy()), shape, bits=bits)
    assert np.array_equal(want, got.numpy())
    # the decode inverts the pack: |value| <= norm, signs kept
    assert np.all(np.abs(got.numpy()) <= norm * (1 + 1e-6))


def test_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError):
        twc.qsgd_pack(x, x, torch.tensor(1.0), bits=3)
    with pytest.raises(ValueError):
        twc.qsgd_pack(x, torch.zeros(4, 64), torch.tensor(1.0), bits=4)
    with pytest.raises(ValueError):
        twc.qsgd_pack(x, x, torch.ones(3), bits=4)
