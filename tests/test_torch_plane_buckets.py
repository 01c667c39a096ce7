"""PyTorch port: the tensor-parallel wire-plane buckets against JAX.

On a model axis M > 1 the JAX train step gives each leaf whose trailing
logical axis maps to ``model`` a wire plane of its own, keyed
``('model', cols)`` (``steps.plane_bucket_tree``,
``plane.bucket_keys_from_axes``, ``ParamPlane._build``). The
compressors draw with ``fold_in(base, bucket)``, so the port's layout
must be JAX's exactly:

- the bucket key tree and the layout (key, lane, leaves, sizes, rows)
  of every config, at its published widths and its smoke size, from
  shape structs only (nothing allocated);
- pack / unpack under buckets: the planes equal JAX's for the same
  numpy tree and unpack back to it;
- the state templates and their split plan (``steps.state_shape_dtype``
  / ``state_shardings``) equal JAX's on a ``2x2`` abstract mesh;
- without a model axis (M = 1) the layout is the single flat plane, as
  before.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.core import plane as plane_mod  # noqa: E402
from repro_torch.core.sdm_dsgd import SDMConfig  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = sorted(configs.all_configs())
METHODS = [("sdm-dsgd", SDMConfig(compressor="fixedk:8")),
           ("sdm-dsgd-fused", SDMConfig(mode="fixedk_rows")),
           ("dc-dsgd", SDMConfig(mode="bernoulli", p=0.95)),
           ("gradient-push", None)]


def _cfgs(arch):
    return [("full", configs.get_config(arch)),
            ("smoke", configs.get_smoke_config(arch))]


def _jax_cfg(arch, size):
    from repro import configs as jconfigs

    return (jconfigs.get_config(arch) if size == "full"
            else jconfigs.get_smoke_config(arch))


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_keys(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _template(cfg, dtype=torch.bfloat16, lead=()):
    return transformer.unflatten({
        k: plane_mod.ShapeDtype(lead + tuple(s), dtype)
        for k, s in transformer.param_shapes(cfg).items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_layout_matches_jax(arch):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import plane as jplane
    from repro.models import transformer as jtf
    from repro.train import steps as jsteps

    for size, cfg in _cfgs(arch):
        tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig())
        keys = steps.plane_bucket_tree(tc, 2)
        jcfg = _jax_cfg(arch, size)
        jkeys = jplane.bucket_keys_from_axes(
            jtf.param_axes(jcfg), jtf.param_shapes(jcfg), jsteps.INNER_RULES)
        assert _flat_keys(keys) == _flat_keys(jkeys)
        with steps.bucket_ctx(tc, 2):
            mine = plane_mod.ParamPlane.for_tree(_template(cfg))
        jtree = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s, jnp.bfloat16),
            jtf.param_shapes(jcfg),
            is_leaf=lambda v: isinstance(v, tuple) and
            all(isinstance(e, int) for e in v))
        with jplane.use_buckets(jkeys):
            theirs = jplane.ParamPlane.for_tree(jtree)
        assert mine.n_buckets == theirs.n_buckets > 1, (size, arch)
        for a, b in zip(mine.buckets, theirs.buckets):
            assert (a.key, a.lane, a.leaves, a.sizes, a.rows) == \
                (b.key, b.lane, b.leaves, b.sizes, b.rows), (size, arch)
        assert mine.padded_size == theirs.padded_size
        # row multiples (the fused kernel's layout) follow JAX's too
        with steps.bucket_ctx(tc, 2):
            mine8 = plane_mod.ParamPlane.for_tree(_template(cfg),
                                                  row_multiple=8)
        with jplane.use_buckets(jkeys):
            theirs8 = jplane.ParamPlane.for_tree(jtree, row_multiple=8)
        assert mine8.plane_shapes() == theirs8.plane_shapes()


def test_pack_and_unpack_under_buckets_match_jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import plane as jplane
    from repro.models import transformer as jtf
    from repro.train import steps as jsteps

    cfg = configs.get_smoke_config("gemma2-2b")
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig())
    rng = np.random.default_rng(0)
    flat = {k: rng.normal(size=s).astype(np.float32)
            for k, s in transformer.param_shapes(cfg).items()}
    tree = transformer.unflatten({k: torch.from_numpy(v)
                                  for k, v in flat.items()})
    with steps.bucket_ctx(tc, 2):
        spec = plane_mod.ParamPlane.for_tree(tree)
        planes = spec.pack(tree)
        back = spec.unpack(planes)
        stacked = tree_mod.tree_map(lambda v: torch.stack([v, 2 * v]), tree)
        sspec = plane_mod.ParamPlane.for_stacked(stacked)
        splanes = sspec.pack_stacked(stacked)
    assert spec.n_buckets == 4
    for a, b in zip(tree_mod.leaves(tree), tree_mod.leaves(back)):
        assert torch.equal(a, b)
    for p, sp in zip(planes, splanes):
        assert torch.equal(sp[0], p) and torch.equal(sp[1], 2 * p)

    jkeys = jplane.bucket_keys_from_axes(
        jtf.param_axes(cfg), jtf.param_shapes(cfg), jsteps.INNER_RULES)
    jtree = transformer.unflatten({k: jnp.asarray(v)
                                   for k, v in flat.items()})
    with jplane.use_buckets(jkeys):
        jplanes = jplane.ParamPlane.for_tree(jtree).pack(jtree)
    assert len(jplanes) == len(planes)
    for p, jp in zip(planes, jplanes):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    # buckets=None forces the flat plane under the context
    with steps.bucket_ctx(tc, 2):
        assert plane_mod.ParamPlane.for_tree(tree, buckets=None) \
            .n_buckets == 1
    del jax


@pytest.mark.parametrize("meth,sdm", METHODS)
def test_state_templates_and_split_plan_match_jax(meth, sdm):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import compat, configs as jconfigs
    from repro.core.gradient_push import GradientPushConfig
    from repro.core.sdm_dsgd import SDMConfig as JSDMConfig
    from repro.train import steps as jsteps

    cfg = configs.get_smoke_config("gemma2-2b")
    if sdm is None:
        from repro_torch.core.gradient_push import GradientPushConfig as GP
        mine_sdm, their_sdm = GP(compressor="fixedk:8"), \
            GradientPushConfig(compressor="fixedk:8")
        topo = "dring"
    else:
        mine_sdm = sdm
        their_sdm = JSDMConfig(**{f: getattr(sdm, f) for f in (
            "p", "theta", "gamma", "sigma", "clip_c", "mode", "compressor")})
        topo = "ring"
    tc = steps.DistributedTrainConfig(model=cfg, sdm=mine_sdm, method=meth,
                                      topology=topo,
                                      param_dtype=torch.float32)
    jtc = jsteps.DistributedTrainConfig(
        model=jconfigs.get_smoke_config("gemma2-2b"), sdm=their_sdm,
        method=meth, topology=topo, param_dtype=jnp.float32)
    jmesh = compat.abstract_mesh((2, 2), ("data", "model"))
    mesh = parse_mesh("2x2")
    shapes = steps.state_shape_dtype(tc, mesh)
    jshapes = jsteps.state_shape_dtype(jtc, jmesh)
    plan = steps.state_shardings(tc, mesh)
    jplan = jsteps.state_shardings(jtc, jmesh)
    assert type(shapes)._fields == type(jshapes)._fields
    for f in type(shapes)._fields:
        got = tree_mod.flatten_with_paths(getattr(shapes, f))
        want = _flat_jax(getattr(jshapes, f))
        assert sorted(got) == sorted(want), f
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (f, k)
        gp = _flat_specs(getattr(plan, f))
        wp = {k: tuple(v.spec) for k, v in _flat_jax(
            getattr(jplan, f)).items()}
        assert gp == wp, f
    del jax


def _flat_jax(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): v for path, v in leaves}


def _flat_specs(tree, prefix=""):
    from repro_torch.sharding import PartitionSpec

    if tree is None:
        return {}
    if isinstance(tree, PartitionSpec):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def test_without_a_model_axis_the_plane_is_one_flat_bucket():
    cfg = configs.get_smoke_config("gemma2-2b")
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig())
    assert steps.plane_bucket_tree(tc, 1) is None
    with steps.bucket_ctx(tc, 1):
        spec = plane_mod.ParamPlane.for_tree(_template(cfg))
    flat = plane_mod.ParamPlane.for_tree(_template(cfg), buckets=None)
    assert spec is flat and spec.n_buckets == 1
    assert spec.buckets[0].key is None and spec.buckets[0].lane == 128
    # a tree the installed key tree does not describe is refused (JAX
    # quietly gives it the flat plane)
    with steps.bucket_ctx(tc, 2):
        with pytest.raises(ValueError, match="bucket keys"):
            plane_mod.ParamPlane.for_tree({"w": torch.zeros(3, 5)})
        other = plane_mod.ParamPlane.for_tree({"w": torch.zeros(3, 5)},
                                              buckets=None)
    assert other.n_buckets == 1
