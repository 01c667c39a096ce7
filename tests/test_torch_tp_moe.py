"""PyTorch port: tensor parallelism over the ``model`` axis for the MoE
family (granite-moe-1b-a400m, qwen3-moe-30b-a3b), against JAX.

- The forward: ``transformer.forward`` + ``lm_loss`` and their gradients
  over M = 2 and M = 4 shards (``convert.shard_params``, a
  ``StackModelAxis`` on the CPU) against the JAX package's unsharded
  forward on the smoke configs (parameters carried over by
  ``convert.params_from_jax``), at ``test_torch_tp_train.py``'s
  tolerances. The experts split by ``experts`` (4 experts: 2 or 1 a
  shard); the expert-fallback variants (3 experts at M = 2, 6 at M = 4,
  which M does not divide) split ``mlp`` inside every expert; a
  capacity-factor 1 variant drops tokens at capacity, the same ones
  in every shard.
- The model-axis counters equal a count derived here from the layer
  list and ``model_axis.tp_collectives`` (remat too).
- Three train steps of granite-moe on ``2x2`` against the JAX package's
  ``make_distributed_train`` on 4 faked devices
  (``tests/helpers/tp_family_check.py``, a subprocess): losses, state,
  the bucket planes, the model-axis counters and the node-axis permutes
  (count and per-device payload shapes).
- ``make_prefill_fn`` / ``make_decode_fn`` on ``1x2`` against JAX's,
  jitted with its serving rules' shardings, for both archs: logits and
  the unsharded cache at 1e-5 of scale, the counters against
  ``tp_serving_collectives`` every step.
- The dry-run on ``NxM`` (one device over a ``ShardModelAxis`` on
  ``meta``): the model-axis collectives equal the formulas.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_family_check as tfc  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives)
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
VARIANTS = {"smoke": {}, "experts3": {"n_experts": 3},
            "experts6": {"n_experts": 6}, "cap1": {"capacity_factor": 1.0}}


def _cfg(arch, variant, jax_side=False):
    if jax_side:
        from repro import configs as jconfigs
        cfg = jconfigs.get_smoke_config(arch)
    else:
        cfg = configs.get_smoke_config(arch)
    return dataclasses.replace(cfg, **VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, variant):
    """JAX's unsharded logits, aux, loss and gradients, and its params."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import transformer as jtf

    jcfg = _cfg(arch, variant, jax_side=True)
    jparams = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)

    def jloss(p):
        logits, aux = jtf.forward(p, jcfg, jnp.asarray(tokens))
        return jtf.lm_loss(logits, jnp.asarray(labels), jcfg.vocab_size,
                           aux), (logits, aux)

    (jl, (jlogits, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    return (tfc.flat(jparams), tokens, labels, float(jl), np.asarray(jlogits),
            float(jaux), tfc.flat(jg))


@pytest.mark.parametrize("arch,variant,m", [
    ("granite-moe-1b-a400m", "smoke", 2), ("granite-moe-1b-a400m", "smoke", 4),
    ("qwen3-moe-30b-a3b", "smoke", 2), ("qwen3-moe-30b-a3b", "smoke", 4),
    ("granite-moe-1b-a400m", "experts3", 2),
    ("qwen3-moe-30b-a3b", "experts6", 4),
    ("granite-moe-1b-a400m", "cap1", 2)])
def test_tp_moe_forward_loss_and_grads_match_jax(arch, variant, m):
    flat, tokens, labels, jl, jlogits, jaux, jg = _jax_reference(arch,
                                                                 variant)
    cfg = _cfg(arch, variant)
    params = params_from_jax(flat, cfg, device="cpu")
    axis = StackModelAxis(m, "cpu")
    shards, logits, aux, loss, grads = tfc.tp_loss_and_grads(
        params, cfg, m, torch.from_numpy(tokens), torch.from_numpy(labels),
        axis)
    e, fe = cfg.n_experts, cfg.d_ff_expert
    w_up = shards["blocks"]["0"]["moe"]["w_up"]
    if e % m:           # the fallback: every expert, f / M of it a shard
        assert w_up.shape == (cfg.n_periods, m, e, cfg.d_model, fe // m)
    else:
        assert w_up.shape == (cfg.n_periods, m, e // m, cfg.d_model, fe)
    assert shards["blocks"]["0"]["moe"]["router"].shape == \
        (cfg.n_periods, cfg.d_model, e)                  # replicated
    assert logits.shape == (m, 2, 24, cfg.padded_vocab // m)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=2e-6)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=2e-6)
    assert jaux > 0
    whole = torch.cat(list(logits.detach()), dim=-1).numpy()
    tfc.close(whole, jlogits, 1e-5, "logits")
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(jg) == sorted(got)
    for k in jg:
        tfc.close(got[k].numpy(), jg[k], 1e-5, k)
    assert axis.calls["all_reduce"] > 0


def test_capacity_drops_the_same_tokens_in_every_shard():
    """At capacity factor 1 the replicated slotting drops tokens; the
    shards' combine equals the unsharded layer, drops included."""
    cfg = _cfg("granite-moe-1b-a400m", "cap1")
    params = transformer.init_params(cfg, seed=3, device="cpu")
    layer = transformer.period_params(params, "0", 0)["moe"]
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want, aux = moe.moe_apply(layer, cfg, x)
    kept, _ = moe.moe_apply(layer, dataclasses.replace(
        cfg, capacity_factor=16.0), x)
    assert not torch.allclose(want, kept)              # tokens dropped
    for m in (2, 4):
        dims = steps.param_shard_dims(cfg, m)
        split = {k: v if dims[f"blocks/0/moe/{k}"] is None else torch.stack(
            v.chunk(m, dims[f"blocks/0/moe/{k}"] - 1)) for k, v in
            layer.items()}
        axis = StackModelAxis(m, "cpu")
        got, taux = moe.moe_apply(split, cfg, x, model_axis=axis)
        assert torch.equal(aux, taux)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        assert axis.calls["all_reduce"] == 1           # g; f counts nothing


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient, counted here from the
    layer list: per attention block the input's copy-in and the output's
    all-reduce (again under remat), K / V all-gathered and reduce-
    scattered where a shard's heads need KV heads beyond its block; per
    MoE block the rows' copy-in, the slot gates' copy-in ((M, e, cap)
    f32) and the combine's all-reduce (again under remat unless it ends
    the period); the vocab-split embedding's all-reduce, the logits'
    copy-in and the loss's max and two all-reduces."""
    calls = dict.fromkeys(("all_reduce", "all_gather", "reduce_scatter",
                           "all_max"), 0)
    nbytes = dict.fromkeys(calls, 0)
    act = m * b * s * cfg.d_model * elt
    kv = b * s * cfg.n_kv_heads * cfg.resolved_head_dim * elt
    gates = m * cfg.n_experts * moe.capacity(cfg, b * s) * 4

    def add(op, n):
        calls[op] += 1
        nbytes[op] += n

    for _ in range(cfg.n_periods):
        for spec in cfg.period:
            assert spec.mixer == "attn" and spec.ffn == "moe"
            add("all_reduce", act)
            for _ in range(1 + cfg.remat):
                add("all_reduce", act)
            if cfg.n_kv_heads % m:
                for _ in range(1 + cfg.remat):
                    add("all_gather", kv)
                    add("all_gather", kv)
                add("reduce_scatter", m * kv)
                add("reduce_scatter", m * kv)
            add("all_reduce", act)
            add("all_reduce", gates)
            add("all_reduce", act)     # the period's last: not recomputed
    for _ in range(2):
        add("all_reduce", act)
    add("all_max", m * b * s * 4)
    for _ in range(2):
        add("all_reduce", m * b * s * 4)
    return calls, nbytes


@pytest.mark.parametrize("arch,variant,m,remat", [
    ("granite-moe-1b-a400m", "smoke", 2, False),
    ("granite-moe-1b-a400m", "smoke", 4, True),
    ("qwen3-moe-30b-a3b", "experts6", 4, False),
    ("granite-moe-1b-a400m", "cap1", 2, True)])
def test_moe_model_axis_counters_equal_the_layer_list(arch, variant, m,
                                                      remat):
    cfg = dataclasses.replace(_cfg(arch, variant), remat=remat)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    axis = StackModelAxis(m, "cpu")
    tfc.tp_loss_and_grads(params, cfg, m, tokens, tokens, axis)
    calls, nbytes = _derived_counts(cfg, m, 2, 24, 4)
    assert axis.calls == calls and axis.bytes == nbytes
    formula = tp_collectives(cfg, m, 2, 24, torch.float32)
    assert {op: v["calls"] for op, v in formula.items()} == calls
    assert {op: v["bytes"] for op, v in formula.items()} == nbytes


# ---------------------------------------------------------------------------
# The train step on 2x2 and the serving steps on 1x2, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax_tp_moe")
    procs = {"train": (tfc.start("train", ARCHS[0], "0", tmp / "train.npz"),
                       tmp / "train.npz")}
    for arch in ARCHS:
        procs[arch] = (tfc.start("serve", arch, "1x2", tmp / f"{arch}.npz"),
                       tmp / f"{arch}.npz")
    return {k: tfc.collect(p, path) for k, (p, path) in procs.items()}


def test_tp_moe_train_steps_match_jax_2x2(jax_cases):
    want = jax_cases["train"]
    run = tfc.port_train_2x2(ARCHS[0], 0, want)
    tfc.check_train_2x2(want, *run, rtol=1e-5)
    tc, params = run[:2]
    with steps.bucket_ctx(tc, 2):
        from repro_torch.core.plane import ParamPlane
        keys = [b.key for b in ParamPlane.for_tree(params).buckets]
    # the experts' w_up / w_gate end in 'mlp': their bucket, though the
    # model axis splits them by experts
    assert ("model", tc.model.d_ff_expert) in keys


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_moe_serving_steps_match_jax_1x2(jax_cases, arch):
    tfc.check_serving_1xm(arch, "1x2", jax_cases[arch], 1e-5)


@pytest.mark.parametrize("arch,mesh_name,shape", [
    ("qwen3-moe-30b-a3b", "2x2", "train_4k"),
    ("granite-moe-1b-a400m", "1x4", "prefill_32k"),
    ("qwen3-moe-30b-a3b", "1x4", "decode_32k")])
def test_dryrun_traces_the_moe_family_on_nxm(arch, mesh_name, shape):
    tfc.check_dryrun_nxm(arch, mesh_name, shape, seq_len=128)
