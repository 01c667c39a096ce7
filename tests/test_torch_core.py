"""PyTorch port: the framework-free copies, the wire plane, the compressors
and the exact wire accounting, against the JAX package.

Same numpy inputs and the same keys through both packages:
- topology matrices, privacy (eps, sigma, T_max), theory and synthetic
  data are equal exactly (the port keeps its own copies);
- the plane layout of ResNet-20 (JAX's sorted-key leaf order) is equal;
- every compressor family's compress -> decompress roundtrip is
  bit-equal to the compiled JAX roundtrip. The QSGD families take a
  per-node l2 norm whose f32 sum the two libraries order differently, so
  their bit-equality inputs are multiples of 1/16 (every partial sum is
  exact); on Gaussian inputs the levels still agree and the values
  differ by at most the norm's rounding;
- wire elements / bits and the per-step transmitted counts are equal
  exactly (integers and Fractions) on the ring, ER(0.35) and matchings:4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import (compressor as jcomp, gossip as jgossip,  # noqa: E402
                        method as jmethod, plane as jplane,
                        privacy as jprivacy, sdm_dsgd as jsdm,
                        theory as jtheory, topology as jtopo)
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import vision_small as jvs  # noqa: E402
from repro_torch import prng, tree as tree_mod  # noqa: E402
from repro_torch.convert import tree_from_jax  # noqa: E402
from repro_torch.core import (compressor as tcomp, gossip as tgossip,  # noqa: E402
                              method as tmethod, plane as tplane,
                              privacy as tprivacy, sdm_dsgd as tsdm,
                              theory as ttheory, topology as ttopo)
from repro_torch.data import synthetic as tdata  # noqa: E402


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _resnet_params():
    p = jvs.resnet20_init(jax.random.PRNGKey(0))
    return p, tree_from_jax(_flat(p), device="cpu")


# --------------------------------------------------------------------------
# framework-free copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [("ring", 8), ("torus", 16), ("er:0.35", 50),
                                    ("star", 7), ("complete", 5), ("er", 12)])
def test_topology_matrices_equal(spec, n):
    jt = jtopo.by_name(spec, n, seed=0)
    tt = ttopo.by_name(spec, n, seed=0)
    assert np.array_equal(jt.weights, tt.weights)
    assert np.array_equal(jt.adjacency, tt.adjacency)
    assert jt.lambda_n == tt.lambda_n and jt.beta == tt.beta


@pytest.mark.parametrize("spec", ["ring", "er:0.35", "matchings:4"])
def test_schedule_sequences_equal(spec):
    js = jgossip.sequence_by_name(spec, 12, seed=3)
    ts = tgossip.sequence_by_name(spec, 12, seed=3)
    assert np.array_equal(js.weights_stack(), ts.weights_stack())
    assert jgossip.needs_replicas(js) == tgossip.needs_replicas(ts)
    for union in (False, True):
        assert jgossip.mean_out_degree(js, union=union) == \
            tgossip.mean_out_degree(ts, union=union)
        assert jgossip.mean_out_degree(js, union=union, node=2) == \
            tgossip.mean_out_degree(ts, union=union, node=2)
    ju, tu = jgossip.union_schedule(js), tgossip.union_schedule(ts)
    assert [r.perm for r in ju.rounds] == [r.perm for r in tu.rounds]


def test_privacy_and_theory_equal():
    kw = dict(G=5.0, m=200, tau=16 / 200, p=0.2, sigma=1.0)
    jp, tp = jprivacy.PrivacyParams(**kw), tprivacy.PrivacyParams(**kw)
    for T in (1, 100, 5000):
        assert jprivacy.epsilon_sdm(jp, T, 1.0) == \
            tprivacy.epsilon_sdm(tp, T, 1.0)
        assert jprivacy.epsilon_alternative(jp, T, 1.0) == \
            tprivacy.epsilon_alternative(tp, T, 1.0)
    for clamp, (G, m, T) in ((True, (5.0, 200, 1000)),
                             (False, (50.0, 20, 100000))):
        assert jprivacy.sigma_for_budget(G, m, 0.2, T, 1.0, clamp=clamp) \
            == tprivacy.sigma_for_budget(G, m, 0.2, T, 1.0, clamp=clamp)
    assert jprivacy.max_iterations(5.0, 200, 0.2, 1.0) == \
        tprivacy.max_iterations(5.0, 200, 0.2, 1.0)
    ja = jprivacy.PrivacyAccountant(jp, 1.0)
    ta = tprivacy.PrivacyAccountant(tp, 1.0)
    for _ in range(7):
        ja.step()
        ta.step()
        assert ja.epsilon == ta.epsilon
    jq = jprivacy.PrivacyParams.from_compressor(
        jcomp.make("qsgdf:4"), G=5.0, m=200, tau=0.08, sigma=1.0)
    tq = tprivacy.PrivacyParams.from_compressor(
        tcomp.make("qsgdf:4"), G=5.0, m=200, tau=0.08, sigma=1.0)
    assert jq.p == tq.p == 1.0
    assert jtheory.theta_upper_bound(0.2, -0.3, 0.05, 1.0) == \
        ttheory.theta_upper_bound(0.2, -0.3, 0.05, 1.0)
    assert jtheory.dcdsgd_min_p(-0.3) == ttheory.dcdsgd_min_p(-0.3)
    assert jtheory.corollary3_rate(50, 1000) == \
        ttheory.corollary3_rate(50, 1000)


def test_synthetic_data_identical():
    (jx, jy), (jxt, jyt) = jdata.classification_dataset(64, 10, 400, 50, 3)
    (tx, ty), (txt, tyt) = tdata.classification_dataset(64, 10, 400, 50, 3)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        assert np.array_equal(a, b)
    jb = jdata.node_partitioned_batches(jx, jy, 8, 5, seed=1)
    tb = tdata.node_partitioned_batches(tx, ty, 8, 5, seed=1)
    for _ in range(3):
        (a, b), (c, d) = next(jb), next(tb)
        assert np.array_equal(a, c) and np.array_equal(b, d)
    js = jdata.TokenStream(vocab_size=50, batch=2, seq_len=6, seed=4)
    ts = tdata.TokenStream(vocab_size=50, batch=2, seq_len=6, seed=4)
    for a, b in zip(js.batch_at(3), ts.batch_at(3)):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# wire plane
# --------------------------------------------------------------------------

def test_plane_layout_and_order_resnet20():
    jp, tp = _resnet_params()
    jspec = jplane.ParamPlane.for_tree(jp)
    tspec = tplane.ParamPlane.for_tree(tp)
    assert jspec.plane_shapes() == tspec.plane_shapes() == ((2128, 128),)
    assert jspec.shapes == tspec.shapes
    # JAX's dict flatten order is sorted: fc, fc_b, s0b0_b1, ...
    assert [k for k in sorted(jp)][:3] == ["fc", "fc_b", "s0b0_b1"]
    (jpl,), (tpl,) = jspec.pack(jp), tspec.pack(tp)
    assert np.array_equal(np.asarray(jpl), tpl.numpy())
    back = tspec.unpack((tpl,))
    assert all(torch.equal(back[k], tp[k]) for k in tp)
    # stacked: (n, rows, 128) per node, and back
    n = 3
    jst = jax.tree.map(lambda v: jnp.stack([v * (i + 1) for i in range(n)]),
                       jp)
    tst = tree_from_jax(_flat(jst), device="cpu")
    sspec = tplane.ParamPlane.for_stacked(tst)
    (jsp,) = jplane.ParamPlane.for_stacked(jst).pack_stacked(jst)
    (tsp,) = sspec.pack_stacked(tst)
    assert tuple(tsp.shape) == (n, 2128, 128)
    assert np.array_equal(np.asarray(jsp), tsp.numpy())
    back = sspec.unpack_stacked((tsp,))
    assert all(torch.equal(back[k], tst[k]) for k in tst)


def test_tree_flatten_matches_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": (3, [4, 5]), "c": None}
    jl = jax.tree.leaves(tree)
    assert tree_mod.leaves(tree) == jl
    state = tsdm.SDMState(x={"w": 1, "b": 2}, s=None, d={"w": 3, "b": 4},
                          step=5)
    assert tree_mod.flatten_with_paths(state) == {
        "x/b": 2, "x/w": 1, "d/b": 4, "d/w": 3, "step": 5}


# --------------------------------------------------------------------------
# compressor roundtrips
# --------------------------------------------------------------------------

SPECS = [("bernoulli", 0.2), ("bernoulli", (0.2, 0.3, 0.5, 0.7, 1.0)),
         ("fixedk", 0.2), ("fixedk", (0.2, 0.3, 0.5, 0.7, 1.0)),
         ("block:16", 0.3), ("rows", 0.3), ("qsgd:8", 0.2), ("qsgd:4", 0.2),
         ("qsgd:2", 0.2), ("qsgd:3", 0.2), ("qsgdf:2", 0.2), ("qsgdf:4", 0.2),
         ("qsgdf:8", 0.2)]


def _roundtrips(spec, p, data, step=5):
    n = data.shape[0]
    base = jax.random.PRNGKey(3)
    keys = jax.vmap(lambda i: jgossip.node_round_key(base, i, step))(
        jnp.arange(n))
    jc = jcomp.make(spec, p)
    fn = jax.jit(jax.vmap(
        lambda i, k, v: jc.decompress(jc.compress(k, v, node=i))))
    want = np.asarray(fn(jnp.arange(n), keys, jnp.asarray(data)))
    tkeys = tgossip.node_round_key(prng.PRNGKey(3), torch.arange(n), step)
    assert np.array_equal(np.asarray(keys).astype(np.int64), tkeys.numpy())
    tc = tcomp.make(spec, p)
    got = tc.decompress(tc.compress(tkeys, torch.from_numpy(data),
                                    node=torch.arange(n)))
    return want, got.numpy()


@pytest.mark.parametrize("spec,p", SPECS)
def test_compressor_roundtrip_bit_equal(spec, p):
    rng = np.random.default_rng(0)
    exact = (rng.integers(-8, 9, size=(5, 9, 128)) / 16).astype(np.float32)
    want, got = _roundtrips(spec, p, exact)
    assert np.array_equal(want, got)
    gauss = (rng.normal(size=(5, 9, 128)) * 0.1).astype(np.float32)
    want, got = _roundtrips(spec, p, gauss)
    if spec.startswith("qsgd"):
        # only the norm's last bit differs: the same levels, so the
        # values agree to the scale's relative rounding
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)
        assert np.array_equal(np.sign(got), np.sign(want))
    else:
        assert np.array_equal(want, got)


def test_compressor_payloads_match():
    """The wire buffers themselves: fixed-k indices and values, qsgdf
    bytes (packed levels + the norm's 4 little-endian bytes)."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-8, 9, size=(9, 128)) / 16).astype(np.float32)
    jk, tk = jax.random.PRNGKey(4), prng.PRNGKey(4)
    for spec in ("fixedk", "block:16", "rows"):
        jpl = jcomp.make(spec, 0.3).compress(jk, jnp.asarray(x))
        tpl = tcomp.make(spec, 0.3).compress(tk, torch.from_numpy(x))
        assert np.array_equal(np.asarray(jpl.indices), tpl.indices.numpy())
        assert np.array_equal(np.asarray(jpl.values), tpl.values.numpy())
    for bits in (2, 4, 8):
        jpl = jax.jit(lambda v: jcomp.make(f"qsgdf:{bits}").compress(
            jk, v).values)(jnp.asarray(x))
        tpl = tcomp.make(f"qsgdf:{bits}").compress(tk, torch.from_numpy(x))
        assert np.array_equal(np.asarray(jpl), tpl.values.numpy())


def test_sdm_config_modes_match():
    for spec in ("bernoulli", "fixedk", "block:64", "rows", "qsgd:4",
                 "qsgdf:4", "qsgdf:8"):
        jc = jsdm.SDMConfig(compressor=spec)
        tc = tsdm.SDMConfig(compressor=spec)
        assert (jc.mode, jc.pack_block, jc.qsgd_bits) == \
            (tc.mode, tc.pack_block, tc.qsgd_bits)
        assert type(jsdm.compressor_of(jc)).__name__ == \
            type(tsdm.compressor_of(tc)).__name__
    with pytest.raises(ValueError):
        tsdm.SDMConfig(compressor="qsgd:4", error_feedback=True)
    with pytest.raises(ValueError):
        tsdm.SDMConfig(p=(0.2, 0.3), compressor="rows")


# --------------------------------------------------------------------------
# exact accounting
# --------------------------------------------------------------------------

def _mlr_params():
    p = jvs.mlr_init(jax.random.PRNGKey(0), 64, 10)
    return p, tree_from_jax(_flat(p), device="cpu")


@pytest.mark.parametrize("topo", ["ring", "er:0.35", "matchings:4"])
@pytest.mark.parametrize("spec,p", SPECS + [("bernoulli", 0.07),
                                            ("fixedk:3", 0.3)])
def test_transmitted_counts_exact(topo, spec, p):
    n = 5
    if isinstance(p, tuple) and len(p) != n:
        p = p[:n]
    jseq = jgossip.sequence_by_name(topo, n, seed=0)
    tseq = tgossip.sequence_by_name(topo, n, seed=0)
    jcfg = jsdm.SDMConfig(p=p, compressor=spec)
    tcfg = tsdm.SDMConfig(p=p, compressor=spec)
    for jparams, tparams in (_mlr_params(), _resnet_params()):
        for seq_j, seq_t in ((None, None), (jseq, tseq)):
            for node in (None, 2):
                assert jsdm.transmitted_elements_per_step(
                    jparams, jcfg, node, seq=seq_j) == \
                    tsdm.transmitted_elements_per_step(
                        tparams, tcfg, node, seq=seq_t)
                for sync in (True, False):
                    assert jsdm.transmitted_bits_per_step(
                        jparams, jcfg, node, index_sync=sync, seq=seq_j) == \
                        tsdm.transmitted_bits_per_step(
                            tparams, tcfg, node, index_sync=sync, seq=seq_t)
        jc, tc = jsdm.compressor_of(jcfg), tsdm.compressor_of(tcfg)
        for shape in ((2128, 128), (62, 128), (1001,), (7, 3, 5)):
            assert jc.wire_elements(shape) == tc.wire_elements(shape)
            assert jc.wire_bits(shape, index_sync=False) == \
                tc.wire_bits(shape, index_sync=False)
            assert jc.wire_elements_exact(shape) == \
                tc.wire_elements_exact(shape)


@pytest.mark.parametrize("name", ["sdm-dsgd", "sdm-dsgd-fused", "dc-dsgd",
                                  "dsgd", "allreduce", "sdm_dsgd",
                                  "gradient-push", "push-sum", "sgp"])
def test_method_registry_accounting_equal(name):
    jm, tm = jmethod.get(name), tmethod.get(name)
    assert jm.name == tm.name
    jp, tp = _resnet_params()
    seq_j = jgossip.sequence_by_name("er:0.35", 50, seed=0)
    seq_t = tgossip.sequence_by_name("er:0.35", 50, seed=0)
    jcfg = jm.coerce_config(jsdm.SDMConfig(p=0.2, compressor="qsgdf:4"))
    tcfg = tm.coerce_config(tsdm.SDMConfig(p=0.2, compressor="qsgdf:4"))
    assert jmethod.transmitted_elements(jm, jp, jcfg, seq=seq_j) == \
        tmethod.transmitted_elements(tm, tp, tcfg, seq=seq_t)
    assert jmethod.transmitted_bits(jm, jp, jcfg, seq=seq_j) == \
        tmethod.transmitted_bits(tm, tp, tcfg, seq=seq_t)
    # every registered method is ported, with its per-node executor
    assert callable(tm.make_distributed) and callable(tm.init_stacked)
    assert set(tmethod.names()) == set(jmethod.names())


def test_phase6_wire_bits_value():
    """The chip smoke test's ResNet-20 x 50 x ER(0.35) qsgdf:4 config
    moves 18,304,742 bits per node per step by the JAX accounting."""
    jp, tp = _resnet_params()
    seq = tgossip.sequence_by_name("er:0.35", 50, seed=0)
    cfg = tsdm.SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0,
                         clip_c=5.0, compressor="qsgdf:4")
    bits = tsdm.transmitted_bits_per_step(tp, cfg, seq=seq)
    assert bits == jsdm.transmitted_bits_per_step(
        jp, jsdm.SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0,
                           clip_c=5.0, compressor="qsgdf:4"),
        seq=jgossip.sequence_by_name("er:0.35", 50, seed=0)) == 18_304_742
    # payload: 2128 * 128 / 2 bytes of levels + 4 norm bytes, per link
    payload = (2128 * 128 // 2 + 4) * 8
    assert round(payload * tsdm.schedule_degree_factor(seq)) == bits
    cfg.validate_against(ttopo.by_name("er:0.35", 50, seed=0))
