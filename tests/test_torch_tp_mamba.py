"""PyTorch port: tensor parallelism over the ``model`` axis for the hybrid
family (jamba-v0.1-52b: mamba and attention mixers, MLP and MoE
feed-forwards), against JAX.

- The forward: ``transformer.forward`` + ``lm_loss`` and their gradients
  over M = 2 and M = 4 shards against the JAX package's unsharded
  forward on jamba's smoke config (one period of 8 slots; ``conv_b`` /
  ``dt_bias`` redrawn as small normals, as in
  ``test_torch_moe_recurrent.py``). The mamba channels split by ``mlp``
  (``w_in``'s columns in JAX's layout, so each shard takes its u / z
  channels from the all-gathered product); the experts by ``experts``.
  A variant: d_model 129 at M = 4 (d_inner 258: ``w_in``'s 516 columns
  split, the channels stay whole). The loss at ``test_torch_tp_train.py``'s
  2e-6; logits (1e-4) and gradients (1e-4 of each leaf's scale) at the
  bounds ``test_torch_moe_recurrent.py`` gives jamba (both packages' f32
  forwards sit ~2e-5 from float64). JAX runs in subprocesses
  (``tests/helpers/tp_family_check.py``), started together.
- The model-axis counters equal a count derived here from the layer
  list and ``model_axis.tp_collectives`` (remat too).
- Three train steps on ``2x2`` against JAX's ``make_distributed_train``
  on 4 faked devices (``tests/helpers/tp_family_check.py``) with the
  smoke period's first 4 slots (mamba + MLP, mamba + MoE, mamba + MLP,
  attention + MoE; the whole period compiles for ~90 s in JAX).
- ``make_prefill_fn`` / ``make_decode_fn`` on ``1x2`` and ``1x4``
  against JAX's, with the mamba states split by channel; logits and the
  unsharded caches at 1e-5 of scale (states 2e-5, as in
  ``test_torch_moe_recurrent.py``), the counters every step.
- ``convert.shard_cache`` / ``unshard_cache`` round trips of the mamba
  states; the dry-run on ``1x4`` / ``2x2`` (one device on ``meta``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_family_check as tfc  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import (params_from_jax, shard_cache,  # noqa: E402
                                 unshard_cache)
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives)
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import mamba, moe, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCH = "jamba-v0.1-52b"
TRAIN_SLOTS = 4
VARIANTS = {"smoke": {}, "experts6": {"n_experts": 6},
            "d129": {"d_model": 129}}
# test_torch_moe_recurrent.py's jamba bounds: logits 1e-4 (the port's
# unsharded logits already sit 1.3e-5 of their scale from JAX's here),
# gradients 1e-4 of each leaf's scale, recurrent states 2e-5
LOGIT_ATOL, GRAD_RTOL, STATE_RTOL = 1e-4, 1e-4, 2e-5


def _cfg(variant):
    return dataclasses.replace(configs.get_smoke_config(ARCH),
                               **VARIANTS[variant])


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax_tp_mamba")
    procs = {"train": (tfc.start("train", ARCH, str(TRAIN_SLOTS),
                                 tmp / "train.npz"), tmp / "train.npz"),
             "serve": (tfc.start("serve", ARCH, "1x2,1x4",
                                 tmp / "serve.npz"), tmp / "serve.npz"),
             "forward": (tfc.start("forward", ARCH, json.dumps(
                 {k: VARIANTS[k] for k in ("smoke", "d129")}),
                 tmp / "forward.npz"), tmp / "forward.npz")}
    return {k: tfc.collect(p, path) for k, (p, path) in procs.items()}


@pytest.mark.parametrize("variant,m", [("smoke", 2), ("smoke", 4),
                                       ("d129", 4)])
def test_tp_jamba_forward_loss_and_grads_match_jax(jax_cases, variant, m):
    want = {k[len(variant) + 1:]: v for k, v in jax_cases["forward"].items()
            if k.startswith(variant + "/")}
    cfg = _cfg(variant)
    params = params_from_jax({k[2:]: v for k, v in want.items()
                              if k.startswith("p/")}, cfg, device="cpu")
    jg = {k[2:]: v for k, v in want.items() if k.startswith("g/")}
    jl, jaux, jlogits = float(want["loss"]), float(want["aux"]), \
        want["logits"]
    tokens, labels = tfc.forward_inputs(cfg.vocab_size)
    axis = StackModelAxis(m, "cpu")
    shards, logits, aux, loss, grads = tfc.tp_loss_and_grads(
        params, cfg, m, torch.from_numpy(tokens), torch.from_numpy(labels),
        axis)
    di = cfg.mamba_d_inner
    mix = shards["blocks"]["0"]["mamba"]
    assert mix["w_in"].shape == (1, m, cfg.d_model, 2 * di // m)
    if di % m:                  # the channels stay whole, w_in does not
        assert mix["conv_w"].shape == (1, cfg.mamba_d_conv, di)
        assert axis.calls["all_gather"] > 0
    else:
        assert mix["conv_w"].shape == (1, m, cfg.mamba_d_conv, di // m)
        assert mix["w_out"].shape == (1, m, di // m, cfg.d_model)
    assert logits.shape == (m, 2, 24, cfg.padded_vocab // m)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=2e-6)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=2e-6)
    whole = torch.cat(list(logits.detach()), dim=-1).numpy()
    np.testing.assert_allclose(whole, jlogits, atol=LOGIT_ATOL)
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(jg) == sorted(got)
    for k in jg:
        tfc.close(got[k].numpy(), jg[k], GRAD_RTOL, k)


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient, counted here from the
    layer list. Per mamba block: the input's copy-in, the ``w_in``
    product's all-gather (again under remat) and its reduce-scatter;
    with split channels also the ``w_x_dbc`` partials' all-reduce (again
    under remat), their copy-in and the output's all-reduce (again under
    remat). Per attention block as ``test_torch_tp_train.py`` counts it;
    per MLP block a copy-in and an all-reduce (again under remat), per
    MoE block the rows' and the gates' copy-in and the combine's
    all-reduce (again under remat unless it ends the period). The
    vocab-split embedding, logits and loss."""
    calls = dict.fromkeys(("all_reduce", "all_gather", "reduce_scatter",
                           "all_max"), 0)
    nbytes = dict.fromkeys(calls, 0)
    t = b * s
    act = m * t * cfg.d_model * elt
    kv = t * cfg.n_kv_heads * cfg.resolved_head_dim * elt
    xz = t * 2 * cfg.mamba_d_inner * elt
    dbc = m * t * (cfg.mamba_dt_rank + 2 * cfg.mamba_d_state) * elt
    gates = m * cfg.n_experts * moe.capacity(cfg, t) * 4
    again = 1 + cfg.remat

    def add(op, n, k=1):
        calls[op] += k
        nbytes[op] += k * n

    for _ in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            last = si == len(cfg.period) - 1
            if spec.mixer == "mamba":
                add("all_reduce", act)
                add("all_gather", xz, again)
                add("reduce_scatter", m * xz)
                if cfg.mamba_d_inner % m == 0:
                    add("all_reduce", dbc, again)
                    add("all_reduce", dbc)
                    add("all_reduce", act, again)
            else:
                add("all_reduce", act, 1 + again)
                if cfg.n_kv_heads % m:
                    add("all_gather", kv, 2 * again)
                    add("reduce_scatter", m * kv, 2)
            if spec.ffn == "mlp":
                add("all_reduce", act, 1 + (1 if last else again))
            else:
                add("all_reduce", act)
                add("all_reduce", gates)
                add("all_reduce", act, 1 if last else again)
    add("all_reduce", act, 2)
    add("all_max", m * t * 4)
    add("all_reduce", m * t * 4, 2)
    return calls, nbytes


@pytest.mark.parametrize("variant,m,remat", [
    ("smoke", 2, False), ("smoke", 4, True), ("experts6", 4, False),
    ("d129", 4, True)])
def test_mamba_model_axis_counters_equal_the_layer_list(variant, m, remat):
    cfg = dataclasses.replace(_cfg(variant), remat=remat)
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
# The train step on 2x2 and the serving steps, against JAX
# ---------------------------------------------------------------------------
def test_tp_jamba_train_steps_match_jax_2x2(jax_cases):
    want = jax_cases["train"]
    run = tfc.port_train_2x2(ARCH, TRAIN_SLOTS, want)
    tfc.check_train_2x2(want, *run, rtol=GRAD_RTOL)
    tc, params = run[:2]
    from repro_torch.core.plane import ParamPlane
    with steps.bucket_ctx(tc, 2):
        spec = ParamPlane.for_tree(params)
    keys = {b.key: b for b in spec.buckets}
    di = tc.model.mamba_d_inner
    # w_in ends in 'mlp' (2 di columns); conv_w, w_dt, conv_b, dt_bias,
    # d_skip in di; a_log, w_x_dbc, w_out end in other axes
    names = {k.rsplit("/", 1)[-1] for k in _bucket_members(params, spec,
                                                           ("model", di))}
    assert {"conv_w", "w_dt", "conv_b", "dt_bias", "d_skip"} <= names
    assert not {"a_log", "w_x_dbc", "w_out"} & names
    assert ("model", 2 * di) in keys


def _bucket_members(params, spec, key):
    flat = list(tree_mod.flatten_with_paths(params))
    b = next(b for b in spec.buckets if b.key == key)
    return [flat[i] for i in b.leaves]


@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_tp_jamba_serving_steps_match_jax(jax_cases, mesh_name):
    tfc.check_serving_1xm(ARCH, mesh_name, jax_cases["serve"], STATE_RTOL)


# ---------------------------------------------------------------------------
# The mamba states' layout and the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name,seq,decode", [
    ("1x2", False, False), ("1x4", False, True), ("2x2", True, True)])
def test_mamba_state_shard_cache_round_trip(mesh_name, seq, decode):
    cfg = configs.get_smoke_config(ARCH)
    mesh = parse_mesh(mesh_name)
    m = mesh.model
    make = steps.make_decode_fn if decode else steps.make_prefill_fn
    _, rules = make(cfg, mesh, shard_cache_seq=seq, device="cpu")
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(7)
    for st in cache.slots.values():
        for t in st:
            t.copy_(torch.randn(t.shape, generator=gen))
    sharded = shard_cache(cache, cfg, rules)
    st = sharded.slots["0"]
    assert isinstance(st, mamba.MambaState)
    di = cfg.mamba_d_inner
    assert st.conv.shape == (1, m, 2, cfg.mamba_d_conv - 1, di // m)
    assert st.ssm.shape == (1, m, 2, di // m, cfg.mamba_d_state)
    back = unshard_cache(sharded, cfg, rules)
    for slot in cache.slots:
        for a, b in zip(cache.slots[slot], back.slots[slot]):
            assert torch.equal(a, b)
    whole = cache.slots["0"]
    for i in range(m):
        one = shard_cache(cache, cfg, rules, index=i).slots["0"]
        assert torch.equal(one.conv[:, 0],
                           whole.conv[..., i * di // m:(i + 1) * di // m])
        assert torch.equal(one.ssm[:, 0],
                           whole.ssm[:, :, i * di // m:(i + 1) * di // m])


@pytest.mark.parametrize("mesh_name,shape", [
    ("1x4", "train_4k"), ("2x2", "prefill_32k"), ("1x4", "decode_32k")])
def test_dryrun_traces_jamba_on_nxm(mesh_name, shape):
    rec = tfc.check_dryrun_nxm(ARCH, mesh_name, shape, seq_len=128)
    assert rec["collective_ops"]["all-gather"] > 0      # the w_in blocks
