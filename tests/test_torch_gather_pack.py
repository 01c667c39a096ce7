"""PyTorch port: the fixed-k sender pack against the JAX package.

``fixedk_gather_pack`` (rows ``idx`` of each node's (nb, block) plane
view, times the f32 rounding of nb/kb) on CPU tensors runs its plain
version, which must equal, bit for bit, both JAX's oracle
``ref.fixedk_gather_pack_ref`` and its Pallas kernel
``fixedk_gather_pack_pallas`` in interpret mode. The CUDA kernel is held
to the plain version on the card (test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wire_compress import ref as jref  # noqa: E402
from repro.kernels.wire_compress.wire_compress import (  # noqa: E402
    fixedk_gather_pack_pallas)
from repro_torch.kernels import wire_compress as twc  # noqa: E402

# (nb, kb): nb not a multiple of 8; kb = nb; nb/kb not exact in f32
SIZES = [(37, 11), (37, 37), (130, 26)]


def _case(n_nodes, nb, kb, block, seed):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n_nodes, nb, block)).astype(np.float32)
    idx = np.stack([rng.permutation(nb)[:kb] for _ in range(n_nodes)]
                   ).astype(np.int32)
    return db, idx


@pytest.mark.parametrize("n_nodes", [1, 4])
@pytest.mark.parametrize("block", [1, 8, 128])
@pytest.mark.parametrize("nb,kb", SIZES)
def test_plain_gather_pack_is_bit_exact_with_jax(n_nodes, block, nb, kb):
    db, idx = _case(n_nodes, nb, kb, block, seed=nb * block + n_nodes)
    scale = nb / kb
    n0 = twc.fixedk_gather_pack.launches
    got = twc.fixedk_gather_pack(torch.from_numpy(db), torch.from_numpy(idx),
                                 scale=scale).numpy()
    assert twc.fixedk_gather_pack.launches == n0      # CPU: never a launch
    assert got.shape == (n_nodes, kb, block) and got.dtype == np.float32
    for i in range(n_nodes):
        want_ref = np.asarray(jref.fixedk_gather_pack_ref(
            jnp.asarray(db[i]), jnp.asarray(idx[i]), scale=scale))
        want_pallas = np.asarray(fixedk_gather_pack_pallas(
            jnp.asarray(db[i]), jnp.asarray(idx[i]), scale=scale,
            interpret=True))
        assert np.array_equal(got[i].view(np.uint32),
                              want_ref.view(np.uint32))
        assert np.array_equal(got[i].view(np.uint32),
                              want_pallas.view(np.uint32))


def test_scale_is_the_f32_rounding_of_nb_over_kb():
    # 37/11 is not an f32: the product uses its rounding, as JAX's weakly
    # typed constant does, not the double
    s = twc.f32_scale(37 / 11)
    assert s.dtype == torch.float32 and float(s) == float(np.float32(37 / 11))
    assert float(s) != 37 / 11


def test_packed_selection_routes_scalar_p_through_the_pack(monkeypatch):
    """Scalar p on an f32 view goes through ``fixedk_gather_pack`` (the
    kernel's wrapper); a per-node p keeps the torch ops, as JAX keeps its
    jnp ops there."""
    from repro_torch import prng
    from repro_torch.core import gossip

    calls = []
    real = twc.fixedk_gather_pack

    def spy(db, idx, *, scale):
        calls.append((tuple(db.shape), idx.dtype, scale))
        return real(db, idx, scale=scale)

    monkeypatch.setattr(twc, "fixedk_gather_pack", spy)
    db = torch.randn(3, 40, 8)
    me = torch.arange(3)
    key = prng.PRNGKey(1)
    kb, idx, vals = gossip._packed_selection(db, 0.25, me, base_key=key,
                                             step=2)
    assert calls == [((3, 40, 8), torch.int32, 40 / 10)] and kb == 10
    want = torch.gather(db, 1, idx[..., None].expand(3, kb, 8)) * twc.f32_scale(
        4.0)
    assert torch.equal(vals, want)
    gossip._packed_selection(db, (0.2, 0.25, 0.5), me, base_key=key, step=2)
    assert len(calls) == 1
