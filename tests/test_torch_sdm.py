"""PyTorch port: the reference executors and the trainer, against the
JAX package run live in the same test (the models: test_torch_vision.py).

- ``ReferenceSimulator`` / ``DSGDReference`` / allreduce, teacher-forced:
  both packages start each checked step from the SAME state (the JAX
  state after a few steps, converted), take one step with the same key
  and batch, and must agree at f32 tolerance. Teacher forcing keeps a
  last-bit difference (a QSGD norm, an XLA-fused multiply-add) from
  compounding over steps. Masks, fixed-k indices and quantizer draws are
  identical by construction (bit-exact PRNG).
The trainer: test_torch_trainer.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import (gossip as jgossip, method as jmethod,  # noqa: E402
                        sdm_dsgd as jsdm, baselines as jbase)
from repro.data import (classification_dataset,  # noqa: E402
                        node_partitioned_batches)
from repro.models import vision_small as jvs  # noqa: E402
from repro_torch import prng, tree as tree_mod  # noqa: E402
from repro_torch.convert import tree_from_jax  # noqa: E402
from repro_torch.core import (gossip as tgossip, method as tmethod,  # noqa: E402
                              sdm_dsgd as tsdm, baselines as tbase)
from repro_torch.models import vision_small as tvs  # noqa: E402

# f32 step tolerance: both sides compute the same f32 arithmetic in a
# different order (dense mixing, XLA fusions with fused multiply-adds)
STEP_RTOL, STEP_ATOL = 2e-5, 2e-6


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                      getattr(p, "idx", p))))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _to_torch(tree):
    return tree_from_jax(_paths(tree), device="cpu") if tree is not None \
        else None


def _assert_tree_close(want, got, rtol=STEP_RTOL, atol=STEP_ATOL, what=""):
    w, g = _paths(want), tree_mod.flatten_with_paths(got)
    assert sorted(w) == sorted(g), (what, sorted(w), sorted(g))
    for k in w:
        np.testing.assert_allclose(tree_mod.to_numpy(g[k]), w[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


# --------------------------------------------------------------------------
# reference executors, teacher-forced single steps
# --------------------------------------------------------------------------

N, FEAT = 6, 16

CASES = {
    # name: (method, config kwargs, topology spec)
    "bernoulli_sigma0": ("sdm-dsgd", dict(p=0.3, theta=0.5, gamma=0.05),
                         "ring"),
    "bernoulli_sigma": ("sdm-dsgd", dict(p=0.3, theta=0.5, gamma=0.05,
                                         sigma=0.5, clip_c=1.0), "ring"),
    "bernoulli_hetp": ("sdm-dsgd", dict(p=(0.2, 0.3, 0.4, 0.5, 0.6, 0.7),
                                        theta=0.3, gamma=0.05, sigma=0.3),
                       "er:0.5"),
    "fixedk": ("sdm-dsgd", dict(compressor="fixedk", p=0.3, theta=0.5,
                                gamma=0.05, sigma=0.5), "er:0.5"),
    "block": ("sdm-dsgd", dict(compressor="block:8", p=0.3, theta=0.5,
                               gamma=0.05), "ring"),
    "rows": ("sdm-dsgd", dict(compressor="rows", p=0.5, theta=0.5,
                              gamma=0.05, sigma=0.2), "ring"),
    "qsgd4": ("sdm-dsgd", dict(compressor="qsgd:4", theta=0.5, gamma=0.05,
                               sigma=0.5, clip_c=2.0), "ring"),
    "qsgdf4": ("sdm-dsgd", dict(compressor="qsgdf:4", theta=0.25,
                                gamma=0.05, sigma=1.0, clip_c=5.0),
               "er:0.35"),
    "qsgdf8_sigma0": ("sdm-dsgd", dict(compressor="qsgdf:8", theta=0.5,
                                       gamma=0.05), "ring"),
    "overlap": ("sdm-dsgd", dict(compressor="qsgdf:4", theta=0.5,
                                 gamma=0.05, sigma=0.5, overlap=True),
                "ring"),
    "time_varying_invariant": ("sdm-dsgd", dict(p=0.3, theta=0.5,
                                                gamma=0.05, sigma=0.5),
                               "ring2x"),
    "replica_matchings": ("sdm-dsgd", dict(compressor="fixedk", p=0.3,
                                           theta=0.5, gamma=0.05, sigma=0.5),
                          "matchings:3"),
    "error_feedback": ("sdm-dsgd", dict(p=0.3, theta=0.5, gamma=0.05,
                                        sigma=0.3, error_feedback=True),
                       "ring"),
    "fused_name": ("sdm-dsgd-fused", dict(compressor="qsgdf:2", theta=0.5,
                                          gamma=0.05, sigma=0.5), "ring"),
    "dc_dsgd": ("dc-dsgd", dict(p=0.5, theta=0.5, gamma=0.05, sigma=0.5),
                "ring"),
    "dsgd": ("dsgd", dict(gamma=0.05, sigma=0.5, clip_c=1.0), "er:0.5"),
    "allreduce": ("allreduce", dict(gamma=0.05), "ring"),
}


def _seqs(spec):
    if spec == "ring2x":        # length-2 weight-invariant sequence
        js = jgossip.sequence_by_name("ring", N)
        ts = tgossip.sequence_by_name("ring", N)
        return (jgossip.ScheduleSequence("ring2x", N, js.schedules * 2),
                tgossip.ScheduleSequence("ring2x", N, ts.schedules * 2))
    return (jgossip.sequence_by_name(spec, N, seed=0),
            tgossip.sequence_by_name(spec, N, seed=0))


def _state_to_torch(state):
    fields = {}
    for f in state._fields:
        v = getattr(state, f)
        fields[f] = int(v) if f == "step" else _to_torch(v)
    return fields


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_step_teacher_forced(case):
    name, kw, spec = CASES[case]
    jseq, tseq = _seqs(spec)
    if name in ("dsgd", "allreduce"):
        jcfg, tcfg = jbase.DSGDConfig(**kw), tbase.DSGDConfig(**kw)
    else:
        jcfg, tcfg = jsdm.SDMConfig(**kw), tsdm.SDMConfig(**kw)
    jm, tm = jmethod.get(name), tmethod.get(name)
    jsim = jm.make_reference(jseq, jm.coerce_config(jcfg))
    tsim = tm.make_reference(tseq, tm.coerce_config(tcfg))
    if name.startswith("sdm") or name == "dc-dsgd":
        assert tsim.replica_exact == jsim.replica_exact
        assert tsim.time_varying == jsim.time_varying

    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(N, FEAT, 10)).astype(np.float32) * 0.3,
          "b": rng.normal(size=(N, 10)).astype(np.float32) * 0.1}
    (xs, ys), _ = classification_dataset(FEAT, 10, 600, 10, seed=0)
    batches = node_partitioned_batches(xs, ys, N, 8, seed=0)
    jgrad = jvs.make_stacked_grad_fn(jvs.mlr_apply)
    tgrad = tvs.make_stacked_grad_fn(tvs.mlr_apply)
    jstep = jax.jit(lambda s, b, k: jsim.step(s, jgrad, b, k))

    jstate = jsim.init(jax.tree.map(jnp.asarray, p0))
    tinit = tsim.init(tree_from_jax(p0, device="cpu"))
    _assert_tree_close(jstate.x, tinit.x, rtol=0, atol=0, what="init x")
    key = jax.random.PRNGKey(5)
    for t in range(4):
        key, sub = jax.random.split(key)
        bx, by = next(batches)
        if t < 2:           # warm up to a state with nonzero s/d/e/nb
            jstate, _ = jstep(jstate, (jnp.asarray(bx), jnp.asarray(by)),
                              sub)
            continue
        tstate = type(tinit)(**_state_to_torch(jstate))
        jnext, jloss = jstep(jstate, (jnp.asarray(bx), jnp.asarray(by)), sub)
        tsub = torch.from_numpy(np.asarray(sub).astype(np.int64))
        tnext, tloss = tsim.step(
            tstate, tgrad, (torch.from_numpy(bx), torch.from_numpy(by)),
            tsub)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert tnext.step == int(jnext.step)
        for f in jnext._fields:
            jv = getattr(jnext, f)
            if f == "step" or jv is None:
                assert f == "step" or getattr(tnext, f) is None
                continue
            _assert_tree_close(jv, getattr(tnext, f), what=f"{case} t{t} {f}")
        jstate = jnext
    # the consensus estimate agrees too
    _assert_tree_close(jsim.consensus(jstate),
                       tsim.consensus(type(tinit)(**_state_to_torch(jstate))),
                       what="consensus")


def test_sparsify_planes_stacked_bit_equal():
    """The wire step alone, given the same d: what each node puts on the
    wire is bit-identical for every family (fixed-point inputs, see
    test_torch_core.py for why QSGD needs them)."""
    rng = np.random.default_rng(3)
    d = {"w": (rng.integers(-8, 9, size=(N, FEAT, 10)) / 16).astype(
        np.float32),
         "b": (rng.integers(-8, 9, size=(N, 10)) / 16).astype(np.float32)}
    jk = jax.random.PRNGKey(2)
    tk = prng.PRNGKey(2)
    for spec in ("bernoulli", "fixedk", "block:8", "rows", "qsgd:4",
                 "qsgdf:2", "qsgdf:4", "qsgdf:8"):
        jc = jsdm.compressor_of(jsdm.SDMConfig(p=0.3, compressor=spec))
        tc = tsdm.compressor_of(tsdm.SDMConfig(p=0.3, compressor=spec))
        want = jax.jit(lambda t: jsdm.sparsify_planes_stacked(
            jc, t, jk, 7, N))(jax.tree.map(jnp.asarray, d))
        got = tsdm.sparsify_planes_stacked(
            tc, tree_from_jax(d, device="cpu"), tk, 7, N)
        _assert_tree_close(want, got, rtol=0, atol=0, what=spec)


def test_sdm_config_validate_and_dataclass():
    from repro_torch.core import topology as ttopo
    cfg = tsdm.SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0,
                         clip_c=5.0)
    cfg.validate_against(ttopo.ring(8))
    with pytest.raises(ValueError, match="Lemma-1"):
        dataclasses.replace(cfg, theta=0.9).validate_against(ttopo.ring(8))
    with pytest.raises(ValueError, match="per-node p"):
        tsdm.ReferenceSimulator(ttopo.ring(4),
                                tsdm.SDMConfig(p=(0.2, 0.3)))
