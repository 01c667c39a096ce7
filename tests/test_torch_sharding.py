"""PyTorch port: the logical-axis sharding rules against the JAX package.

- ``repro_torch.sharding.MeshRules.spec`` equals ``repro.sharding.
  MeshRules.spec`` (run live on an abstract mesh) over the cases of
  ``tests/test_sharding_rules.py`` and over every parameter leaf of the
  ten configs at model axes of 2, 4 and 16 (the inner rules and the
  node-stacked outer rules);
- ``INNER_RULES``, ``outer_rules``, ``serving_rules``,
  ``transformer.param_axes`` and ``cache_logical_axes`` equal JAX's;
- the mesh specs of the launcher: ``NxM`` parses, the pod meshes raise.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import MeshRules, logical, use_rules  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = sorted(configs.all_configs())


def _jax():
    pytest.importorskip("jax")
    from repro import compat
    from repro import sharding as jsharding

    return compat, jsharding


def _both(shape, names, mapping):
    compat, jsharding = _jax()
    return (MeshRules(dict(zip(names, shape)), mapping),
            jsharding.MeshRules(compat.abstract_mesh(shape, names), mapping))


# (mesh shape, axis names, mapping, axes, shape): tests/test_sharding_rules
RULE_CASES = [
    ((1, 1), ("data", "model"), {"batch": "data", "mlp": "model"},
     ("batch", None, "mlp"), (8, 4, 16)),
    ((2, 4), ("data", "model"), {"heads": "model"}, ("heads",), (6,)),
    ((2, 4), ("data", "model"), {"heads": "model"}, ("heads",), (8,)),
    ((2, 4), ("data", "model"), {"a": "model", "b": "model"}, ("a", "b"),
     (8, 8)),
    ((2, 2, 2), ("pod", "data", "model"), {"batch": ("pod", "data")},
     ("batch",), (8,)),
    ((2, 2, 2), ("pod", "data", "model"), {"batch": ("pod", "data")},
     ("batch",), (6,)),
    ((2,), ("data",), {"mlp": "model"}, ("mlp",), (8,)),
    ((2, 4), ("data", "model"), {"mlp": "model"}, ("mlp", None, None),
     (8, 3, 5)),
    ((2, 4), ("data", "model"), {"mlp": "model"}, (None, "mlp"), None),
]


@pytest.mark.parametrize("mesh_shape,names,mapping,axes,shape", RULE_CASES)
def test_spec_matches_jax_on_the_rule_cases(mesh_shape, names, mapping, axes,
                                            shape):
    mine, theirs = _both(mesh_shape, names, mapping)
    assert tuple(mine.spec(axes, shape)) == tuple(theirs.spec(axes, shape))


def _flat_axes(tree, prefix=""):
    """{'/'-joined key: axes tuple} of a nested dict of axes tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_axes(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    _jax()
    from repro import configs as jconfigs
    from repro.models import transformer as jtf

    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        mine = _flat_axes(transformer.param_axes(get(arch)))
        theirs = _flat_axes(jtf.param_axes(jget(arch)))
        assert mine == theirs
        shapes = transformer.param_shapes(get(arch))
        assert sorted(shapes) == sorted(mine)
        assert all(len(shapes[k]) == len(mine[k]) for k in mine)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m", [2, 4, 16])
def test_every_leaf_spec_matches_jax(arch, m):
    """Every leaf of the published config under the inner rules (a node's
    model axis) and the outer rules (the node-stacked state), and the
    dimension ``param_shard_dims`` splits."""
    _jax()
    from repro.train import steps as jsteps

    cfg = configs.get_config(arch)
    inner, jinner = _both((1, m), ("data", "model"), steps.INNER_RULES)
    outer, jouter = _both((4, m), ("data", "model"),
                          steps.outer_rules(("data",)))
    assert jsteps.INNER_RULES == steps.INNER_RULES
    dims = steps.param_shard_dims(cfg, m)
    for key, spec in transformer.flat_specs(cfg):
        got = tuple(inner.spec(spec.axes, spec.shape))
        assert got == tuple(jinner.spec(spec.axes, spec.shape)), key
        lead = ("batch",) + spec.axes, (8,) + spec.shape
        assert tuple(outer.spec(*lead)) == tuple(jouter.spec(*lead)), key
        want = got.index("model") if "model" in got else None
        assert dims[key] == want, key
        if want is not None:
            assert spec.shape[want] % m == 0


def test_rule_tables_equal_jax():
    _jax()
    from repro.train import steps as jsteps

    assert steps.INNER_RULES == jsteps.INNER_RULES
    for node_axes in (("data",), ("pod", "data")):
        assert steps.outer_rules(node_axes) == jsteps.outer_rules(node_axes)
        for shard in (False, True):
            for decode in (False, True):
                assert steps.serving_rules(
                    node_axes, shard_cache_seq=shard, decode=decode) == \
                    jsteps.serving_rules(node_axes, shard_cache_seq=shard,
                                         decode=decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_axes_match_jax(arch):
    _jax()
    from repro import configs as jconfigs
    from repro.models import transformer as jtf

    mine = transformer.cache_logical_axes(configs.get_smoke_config(arch))
    theirs = jtf.cache_logical_axes(jconfigs.get_smoke_config(arch))
    assert mine.offset == theirs.offset == ()
    assert sorted(mine.slots) == sorted(theirs.slots)
    for k in mine.slots:
        assert type(mine.slots[k]).__name__ == type(theirs.slots[k]).__name__
        assert tuple(mine.slots[k]) == tuple(theirs.slots[k])


def test_logical_is_an_annotation():
    x = torch.ones(2, 3)
    assert logical(x, "batch", "embed") is x
    with use_rules(MeshRules({"model": 2}, steps.INNER_RULES)):
        assert logical(x, "batch", "embed") is x
        with pytest.raises(ValueError, match="logical axes"):
            logical(x, "batch")


@pytest.mark.parametrize("name,nodes,model", [
    ("2x2", 2, 2), ("4x4", 4, 4), ("2x1x2", 2, 2), ("8", 8, 1)])
def test_mesh_names_give_nodes_and_model_axis(name, nodes, model):
    mesh = mesh_mod.make_mesh_by_name(name)
    assert (mesh.n_nodes, mesh.model) == (nodes, model)
    assert "model" not in mesh_mod.node_axis_names(mesh)


@pytest.mark.parametrize("name", mesh_mod.POD_MESHES)
def test_pod_meshes_raise_with_the_roadmap_item(name):
    with pytest.raises(ValueError, match="ROADMAP Queue 1, item 4"):
        mesh_mod.parse_mesh(name)
