"""PyTorch port: the library's leftovers against the JAX package.

Each port function runs beside its JAX counterpart in the same test, on
the same numpy inputs and keys from a seed:

- ``repro_torch.optim``: ``sgd`` / ``momentum`` / ``adamw`` over 20
  steps of a 3-leaf tree with ``cosine_schedule`` as the learning rate
  (1e-6 relative), the three on ``tests/test_substrates.py``'s
  quadratic, ``global_norm_clip``'s output and norm;
- ``core.sparsifier``: ``bernoulli_mask``, ``fixedk_pack``,
  ``fixedk_unpack``, ``fixedk_sparsify`` and ``block_sparsify`` bit for
  bit under the same key, ``sparsifier_variance`` at 1e-6;
- ``core.compressor.tree_wire_bits`` / ``tree_wire_elements`` on the
  ResNet-20 and LM trees for every registered compressor;
  ``core.clipping.sensitivity_G``;
- ``checkpoint``: ``tree_keys`` on a nested dict / tuple / NamedTuple
  state, a checkpoint the JAX package writes (bf16 leaves) restored by
  the port and the port's restored by the JAX package, a deflated
  archive restored as the stored one, and the missing-key and
  opaque-width errors.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import clipping as jclipping  # noqa: E402
from repro.core import compressor as jcompressor  # noqa: E402
from repro.core import sparsifier as jsparsifier  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import clipping as tclipping  # noqa: E402
from repro_torch.core import compressor as tcompressor  # noqa: E402
from repro_torch.core import sparsifier as tsparsifier  # noqa: E402

SHAPES = {"w": (7, 5), "b": (5,), "emb": (3, 4, 2)}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _make(kind, mod):
    sched = mod.cosine_schedule(0.05, warmup=5, total=20)
    return {"sgd": mod.sgd(sched), "momentum": mod.momentum(sched, 0.8),
            "adamw": mod.adamw(sched, weight_decay=0.01)}[kind]


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_optimizer_matches_jax_over_20_steps(kind):
    rng = np.random.default_rng(11)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(20)]
    opt_t, opt_j = _make(kind, toptim), _make(kind, joptim)
    pt = {k: torch.from_numpy(v) for k, v in p0.items()}
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st, sj = opt_t.init(pt), opt_j.init(pj)
    for g in grads:
        pt, st = opt_t.update({k: torch.from_numpy(v) for k, v in g.items()},
                              st, pt)
        pj, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                              sj, pj)
    assert int(st.step) == int(sj.step) == 20
    for k in SHAPES:
        assert pt[k].dtype == torch.float32
        assert _rel_err(pt[k].numpy(), pj[k]) < 1e-6, k
        if kind != "sgd":
            assert _rel_err(st.mu[k].numpy(), sj.mu[k]) < 1e-6, k
        if kind == "adamw":
            assert _rel_err(st.nu[k].numpy(), sj.nu[k]) < 1e-6, k


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_optimizers_minimize_the_quadratic_as_jax_does(kind):
    """``tests/test_substrates.py``'s quadratic: 200 steps on
    w = (3, -2) with grad 2 w reach |w| < 1e-2, at JAX's iterates."""
    opt_t = {"sgd": toptim.sgd(0.1), "momentum": toptim.momentum(0.05),
             "adamw": toptim.adamw(0.1)}[kind]
    opt_j = {"sgd": joptim.sgd(0.1), "momentum": joptim.momentum(0.05),
             "adamw": joptim.adamw(0.1)}[kind]
    pt, pj = {"w": torch.tensor([3.0, -2.0])}, {"w": jnp.array([3.0, -2.0])}
    st, sj = opt_t.init(pt), opt_j.init(pj)
    for _ in range(200):
        pt, st = opt_t.update({"w": 2 * pt["w"]}, st, pt)
        pj, sj = opt_j.update({"w": 2 * pj["w"]}, sj, pj)
    assert float(pt["w"].abs().max()) < 1e-2
    assert np.allclose(pt["w"].numpy(), np.asarray(pj["w"]), rtol=1e-5,
                       atol=1e-7)


def test_cosine_schedule_matches_jax():
    ft = toptim.cosine_schedule(1.0, warmup=10, total=100)
    fj = joptim.cosine_schedule(1.0, warmup=10, total=100)
    for s in (0, 3, 10, 11, 55, 99, 100, 140):
        got = float(ft(torch.tensor(s, dtype=torch.int32)))
        want = float(fj(jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s
    assert float(ft(0)) == 0.0


@pytest.mark.parametrize("max_norm", [1.5, 100.0])
def test_global_norm_clip_matches_jax(max_norm):
    rng = np.random.default_rng(4)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    ct, nt = toptim.global_norm_clip(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    cj, nj = joptim.global_norm_clip(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    for k in SHAPES:
        assert _rel_err(ct[k].numpy(), cj[k]) < 1e-6
    if max_norm > float(nj):
        assert all(torch.equal(ct[k], torch.from_numpy(g[k])) for k in g)


# --------------------------------------------------------------------------
# The sparsifier.
# --------------------------------------------------------------------------

def _keys(seed):
    return prng.PRNGKey(seed), jax.random.PRNGKey(seed)


@pytest.mark.parametrize("p", [0.05, 0.3, 0.9])
def test_bernoulli_mask_is_jax_s(p):
    kt, kj = _keys(3)
    got = tsparsifier.bernoulli_mask(kt, (17, 9), p)
    want = np.asarray(jsparsifier.bernoulli_mask(kj, (17, 9), p))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32)


@pytest.mark.parametrize("d,p", [(1000, 0.1), (257, 0.3), (64, 1.0)])
def test_fixedk_pack_unpack_sparsify_are_jax_s(d, p):
    rng = np.random.default_rng(d)
    x = rng.normal(size=d).astype(np.float32)
    kt, kj = _keys(9)
    k = tsparsifier.num_kept(d, p)
    assert k == jsparsifier.num_kept(d, p)
    idx_t = tsparsifier.fixedk_indices(kt, d, k)
    idx_j = jsparsifier.fixedk_indices(kj, d, k)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    vt = tsparsifier.fixedk_pack(torch.from_numpy(x), idx_t, d)
    vj = jsparsifier.fixedk_pack(jnp.asarray(x), idx_j, d)
    assert np.array_equal(_bits(vt.numpy()), _bits(vj))
    ut = tsparsifier.fixedk_unpack(vt, idx_t, d)
    uj = jsparsifier.fixedk_unpack(vj, idx_j, d)
    assert np.array_equal(_bits(ut.numpy()), _bits(uj))
    st = tsparsifier.fixedk_sparsify(kt, torch.from_numpy(x), p)
    sj = jsparsifier.fixedk_sparsify(kj, jnp.asarray(x), p)
    assert np.array_equal(_bits(st.numpy()), _bits(sj))
    assert int((st != 0).sum()) == k


@pytest.mark.parametrize("d,p,block", [(1000, 0.2, 8), (1001, 0.3, 16),
                                       (50, 0.5, 1)])
def test_block_sparsify_is_jax_s(d, p, block):
    x = np.random.default_rng(d + block).normal(size=d).astype(np.float32)
    kt, kj = _keys(5)
    got = tsparsifier.block_sparsify(kt, torch.from_numpy(x), p, block)
    want = jsparsifier.block_sparsify(kj, jnp.asarray(x), p, block)
    assert got.shape == (d,)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("p", [0.1, 0.25, 1.0])
def test_sparsifier_variance_matches_jax(p):
    x = np.random.default_rng(2).normal(size=(31, 7)).astype(np.float32)
    got = float(tsparsifier.sparsifier_variance(torch.from_numpy(x), p))
    want = float(jsparsifier.sparsifier_variance(jnp.asarray(x), p))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


# --------------------------------------------------------------------------
# Tree wire accounting and the sensitivity bound.
# --------------------------------------------------------------------------

def _resnet20_shapes():
    from repro.models import vision_small

    tree = jax.eval_shape(vision_small.resnet20_init, jax.random.PRNGKey(0))
    return {"/".join(str(getattr(q, "key", q)) for q in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _lm_shapes():
    from repro_torch import configs
    from repro_torch.models import transformer

    return dict(transformer.param_shapes(
        configs.get_smoke_config("gemma2-2b")))


SPECS = ["bernoulli", "fixedk", "fixedk:128", "block:64", "rows", "qsgd",
         "qsgd:2", "qsgd:4", "qsgdf", "qsgdf:2", "qsgdf:8"]


@pytest.mark.parametrize("tree_name", ["resnet20", "lm"])
@pytest.mark.parametrize("p", [0.2, (0.1, 0.25, 0.3)])
def test_tree_wire_bits_and_elements_match_jax(tree_name, p):
    from repro_torch.core.plane import ShapeDtype

    shapes = _resnet20_shapes() if tree_name == "resnet20" else _lm_shapes()
    tree_t = {k: ShapeDtype(tuple(s), torch.float32)
              for k, s in shapes.items()}
    tree_j = {k: jax.ShapeDtypeStruct(tuple(s), jnp.float32)
              for k, s in shapes.items()}
    assert {spec.split(":")[0] for spec in SPECS} == set(tcompressor.names())
    assert tuple(tcompressor.names()) == tuple(jcompressor.names())
    for spec in SPECS:
        if isinstance(p, tuple) and spec.split(":")[0] in ("qsgd", "qsgdf"):
            continue
        ct, cj = tcompressor.make(spec, p=p), jcompressor.make(spec, p=p)
        nodes = (None,) if not isinstance(p, tuple) else (0, 1, 2)
        for node in nodes:
            got = tcompressor.tree_wire_elements(ct, tree_t, node=node)
            want = jcompressor.tree_wire_elements(cj, tree_j, node=node)
            assert isinstance(got, int) and got == want, (spec, node)
            for kw in (dict(), dict(value_bits=16, index_sync=True)):
                got = tcompressor.tree_wire_bits(ct, tree_t, node=node, **kw)
                want = jcompressor.tree_wire_bits(cj, tree_j, node=node,
                                                  **kw)
                assert isinstance(got, int) and got == want, (spec, node, kw)


@pytest.mark.parametrize("c,d", [(0.01, 784 * 10), (1e-4, 901_300_000),
                                 (2.5, 1)])
def test_sensitivity_G_matches_jax(c, d):
    assert tclipping.sensitivity_G(c, d) == jclipping.sensitivity_G(c, d)


# --------------------------------------------------------------------------
# Checkpoints.
# --------------------------------------------------------------------------

def _state_pair():
    """The same nested dict / tuple / NamedTuple state in both packages
    (bf16, f32, int8 and int32 leaves, a None subtree)."""
    from repro.core import baselines as jbaselines
    from repro.core import sdm_dsgd as jsdm
    from repro_torch.core import baselines as tbaselines
    from repro_torch.core import sdm_dsgd as tsdm

    rng = np.random.default_rng(8)
    w = rng.normal(size=(2, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    pl = rng.normal(size=(4, 8)).astype(np.float32)
    q = rng.integers(-100, 100, size=(5,)).astype(np.int8)

    def build(xp, bf16, sdm, base):
        return {"opt": base.DSGDState(x={"w": xp(w), "b": xp(b).astype(bf16)
                                         if xp is jnp.asarray
                                         else xp(b).to(bf16)}, step=7),
                "sdm": sdm.SDMState(x={"w": xp(w)}, s=(xp(pl),), d=(xp(pl),),
                                    step=3, e=None, xhat=None, nb=None),
                "extras": (xp(q), [xp(w)])}

    jt = build(jnp.asarray, jnp.bfloat16, jsdm, jbaselines)
    tt = build(torch.from_numpy, torch.bfloat16, tsdm, tbaselines)
    return tt, jt


def test_tree_keys_match_jax():
    tt, jt = _state_pair()
    keys = tckpt.tree_keys(tt)
    assert keys == jckpt.tree_keys(jt)
    assert "opt/x/b" in keys and "sdm/s/0" in keys and "extras/1/0" in keys


def _assert_same(got, want):
    from repro_torch import tree as tree_mod

    gl, wl = tree_mod.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if isinstance(g, torch.Tensor):
            wf = np.asarray(w, np.float32)
            assert g.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.int8): torch.int8}.get(
                np.asarray(w).dtype, torch.bfloat16)
            assert np.array_equal(g.float().numpy(), wf)
        else:
            assert g == int(w)


def test_jax_checkpoint_restored_by_the_port_and_back(tmp_path):
    tt, jt = _state_pair()
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jt)
    got = tckpt.restore_checkpoint(str(tmp_path / "jax"), tt)
    _assert_same(got, jt)
    assert got["opt"].x["b"].dtype == torch.bfloat16
    assert isinstance(got["sdm"].step, int) and got["sdm"].step == 3

    path = tckpt.save_checkpoint(str(tmp_path / "port"), 9, tt)
    assert path.endswith("step_00000009.npz")
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), jt)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(np.asarray(g, np.float32),
                              np.asarray(w, np.float32))
    # the port's own round trip, and an explicit device and step
    again = tckpt.restore_checkpoint(str(tmp_path / "port"), tt, step=9,
                                     device="cpu")
    _assert_same(again, jt)


def test_restore_casts_to_the_exemplar_dtype(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), 1, {"w": jnp.linspace(0, 1, 5)})
    got = tckpt.restore_checkpoint(
        str(tmp_path), {"w": torch.zeros(5, dtype=torch.bfloat16)})
    want = jckpt.restore_checkpoint(str(tmp_path),
                                    {"w": jnp.zeros(5, jnp.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].float().numpy(),
                          np.asarray(want["w"], np.float32))


def test_restore_reads_a_compressed_archive_as_a_stored_one(tmp_path):
    """An archive whose members are deflated (``np.savez_compressed``)
    restores through ``np.load`` to what the stored archive gives by its
    direct reads, bf16 leaves included."""
    tt, _ = _state_pair()
    path = tckpt.save_checkpoint(str(tmp_path / "stored"), 3, tt)
    flat = tckpt.load_flat(path)
    os.makedirs(tmp_path / "deflated")
    np.savez_compressed(tmp_path / "deflated" / "step_00000003.npz", **flat)
    assert tckpt.npz._stored_arrays(
        str(tmp_path / "deflated" / "step_00000003.npz")) == {}
    assert len(tckpt.npz._stored_arrays(path)) == len(flat)
    got = tckpt.restore_checkpoint(str(tmp_path / "deflated"), tt)
    want = tckpt.restore_checkpoint(str(tmp_path / "stored"), tt)
    from repro_torch import tree as tree_mod
    for g, w in zip(tree_mod.leaves(got), tree_mod.leaves(want)):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g == w


def test_restore_raises_on_a_missing_key_and_an_opaque_width(tmp_path):
    jckpt.save_checkpoint(str(tmp_path), 2,
                          {"w": jnp.ones((3,), jnp.bfloat16)})
    with pytest.raises(KeyError):
        jckpt.restore_checkpoint(str(tmp_path), {"v": jnp.zeros(3)})
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path), {"v": torch.zeros(3)})
    with pytest.raises(ValueError, match="opaque dtype"):
        jckpt.restore_checkpoint(str(tmp_path),
                                 {"w": jnp.zeros(3, jnp.float32)})
    with pytest.raises(ValueError, match="opaque dtype"):
        tckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "missing"),
                                 {"w": torch.zeros(3)})
