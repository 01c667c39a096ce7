"""PyTorch port: the split inside a head over the ``model`` axis, against
JAX.

JAX's rules map ``heads_flat`` / ``kv_flat`` to ``model`` and leave a
dimension whole only where M does not divide its width, so where M does
not divide the heads GSPMD splits the columns of ``wq`` / ``wk`` /
``wv`` / ``wo`` (and rwkv's ``w_r`` / ``w_k`` / ``w_v`` / ``w_decay``)
inside a head. The port's shards all-gather Q (and K / V), attend the
whole heads their block of columns touches and read out their own
columns (``layers._query_heads``); rwkv's all-gather r, k and the
decay's projection and run the WKV loop over their own columns, with the
state held by columns (``rwkv._column_heads``).

- The forward, ``lm_loss`` and every gradient against JAX's unsharded
  forward at ``test_torch_tp_train.py``'s tolerances (loss rtol 2e-6,
  logits and gradients 1e-5 of their scale): gemma2-2b smoke at M = 8
  (half a query head and a quarter of a KV head a shard), a 6-head,
  2-KV-head variant at M = 4 (1.5 heads a shard, GQA group 3), whisper
  and llama-3.2-vision smoke at M = 8 on a seeded context, rwkv6 smoke
  at M = 8 and a 2-head variant (head size 64) at M = 4.
- The model-axis counters equal a count derived here from the layer list
  and ``model_axis.tp_collectives`` (remat too).
- Three train steps on ``2x2`` against JAX's compiled
  ``make_distributed_train`` on 4 faked devices: a 3-query-head,
  1-KV-head gemma2 variant (1.5 heads and half a KV head a shard),
  sdm-dsgd ``fixedk_packed`` (fixedk:8) with sigma 0.1: losses at rtol
  1e-5, the state, the node-axis permutes and payload shapes.
- ``make_prefill_fn`` + 4 steps of ``make_decode_fn`` on ``1x4`` against
  JAX's: the 6-head variant (a whole prefill cache, then a cache split by
  positions) and the 2-head rwkv6 variant (the WKV state by columns);
  the caches after ``unshard_cache``; the counters every step.
- Seeded faults fail against JAX: the all-gather's backward replaced by
  a plain slice (each shard keeps its own copy's gradient: the score
  gradients of the shards that share a head are not summed), and each
  shard reading out its neighbour's columns of a cut head.
- The dry-run traces gemma2-2b, phi3-medium-14b, qwen1.5-32b and
  rwkv6-3b on ``16x16`` and whisper-large-v3 on ``16x8`` on ``meta``;
  ``launch.train --mesh 1x8`` trains each smoke config.
- What still raises: ragged offsets and rule overrides.

JAX runs in two subprocesses of ``tests/helpers/tp_family_check.py``,
started together (the train case; the forward and serve cases).
"""
import contextlib
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_family_check as tfc  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import (params_from_jax, shard_cache,  # noqa: E402
                                 shard_params, unshard_cache)
from repro_torch.core import model_axis as ma  # noqa: E402
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives,
                                         tp_serving_collectives)
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

H6 = {"n_heads": 6, "n_kv_heads": 2, "head_dim": 32}
H3 = {"n_heads": 3, "n_kv_heads": 1, "head_dim": 32}
RWKV_H2 = {"rwkv_head_size": 64}
# name: (arch, config overrides, M)
FORWARD = {
    "gemma2_m8": ("gemma2-2b", {}, 8),
    "gemma2_h6_m4": ("gemma2-2b", H6, 4),
    "whisper_m8": ("whisper-large-v3", {}, 8),
    "vision_m8": ("llama-3.2-vision-11b", {}, 8),
    "rwkv_m8": ("rwkv6-3b", {}, 8),
    "rwkv_h2_m4": ("rwkv6-3b", RWKV_H2, 4),
}
SERVE = {"gemma2_h6": ("gemma2-2b", H6), "rwkv_h2": ("rwkv6-3b", RWKV_H2)}
TRAIN = json.dumps({"slots": 0, "model": H3})
# test_torch_tp_train.py's bounds: the loss at 2e-6 relative, the logits
# and the gradients at 1e-5 of their scale; test_torch_tp_serving.py's
# 1e-5 of scale for the serving logits and caches
LOSS_RTOL, RTOL = 2e-6, 1e-5


def _cfg(arch, over):
    return dataclasses.replace(configs.get_smoke_config(arch), **over)


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax_tp_head_split")
    by_arch = {}
    for name, (arch, over, _) in FORWARD.items():
        by_arch.setdefault(arch, {})[name] = over
    jobs = {f"forward/{arch}": ["forward", arch, json.dumps(v)]
            for arch, v in by_arch.items()}
    jobs.update({f"serve/{name}": ["serve", arch, json.dumps(
        {"meshes": "1x4", "model": over})]
        for name, (arch, over) in SERVE.items()})
    procs = {"train": (tfc.start("train", "gemma2-2b", TRAIN,
                                 tmp / "train.npz"), tmp / "train.npz"),
             "many": (tfc.start("many", "-", json.dumps(jobs),
                                tmp / "many.npz"), tmp / "many.npz")}
    out = {k: tfc.collect(p, path) for k, (p, path) in procs.items()}
    many = out.pop("many")
    for name in FORWARD:
        arch = FORWARD[name][0]
        pre = f"forward/{arch}/{name}/"
        out[name] = {k[len(pre):]: v for k, v in many.items()
                     if k.startswith(pre)}
    for name in SERVE:
        pre = f"serve/{name}/"
        out[name] = {k[len(pre):]: v for k, v in many.items()
                     if k.startswith(pre)}
    return out


def _forward_case(jax_cases, name):
    arch, over, m = FORWARD[name]
    cfg = _cfg(arch, over)
    want = jax_cases[name]
    params = params_from_jax({k[2:]: v for k, v in want.items()
                              if k.startswith("p/")}, cfg, device="cpu")
    return cfg, m, params, want


def _inputs(cfg):
    tokens, labels = tfc.forward_inputs(cfg.vocab_size)
    ctx = tfc.context_input(cfg, len(tokens))
    return (torch.from_numpy(tokens), torch.from_numpy(labels),
            None if ctx is None else torch.from_numpy(ctx))


# ---------------------------------------------------------------------------
# The forward, the loss and the gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FORWARD))
def test_head_split_forward_loss_and_grads_match_jax(jax_cases, name):
    cfg, m, params, want = _forward_case(jax_cases, name)
    tokens, labels, ctx = _inputs(cfg)
    axis = StackModelAxis(m, "cpu")
    shards, logits, aux, loss, grads = tfc.tp_loss_and_grads(
        params, cfg, m, tokens, labels, axis, context=ctx)
    blk = shards["blocks"]["0"]
    if cfg.family == "ssm":                       # columns cut a head
        h, n = cfg.rwkv_n_heads, cfg.rwkv_head_size
        assert h % m and blk["time_mix"]["w_r"].shape[1:] == (
            m, cfg.d_model, h * n // m)
        assert blk["time_mix"]["decay_bias"].shape[1:] == (h, n)  # whole
    else:
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        assert h % m and blk["attn"]["wq"].shape[1:] == (
            m, cfg.d_model, h * hd // m)
        assert blk["attn"]["wk"].shape[1:] == (
            m, cfg.d_model, cfg.n_kv_heads * hd // m)
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]),
                               rtol=LOSS_RTOL)
    tfc.close(torch.cat(list(logits.detach()), -1).numpy(), want["logits"],
              RTOL, "logits")
    jg = {k[2:]: v for k, v in want.items() if k.startswith("g/")}
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(jg) == sorted(got)
    for k in jg:
        tfc.close(got[k].numpy(), jg[k], RTOL, k)


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient of a text decoder whose
    heads M cuts, counted here from the layer list: per attention layer
    the input's copy-in (backward) and the output's all-reduce, Q and
    (M cutting the KV heads too) K and V all-gathered and reduce-
    scattered; per MLP the copy-in and the all-reduce; per rwkv time mix
    the copy-in, ``w_out``'s all-reduce and r, k and the decay's
    projection all-gathered and reduce-scattered, per channel mix its
    copy-in, the ``w_v`` partials' all-reduce and ``w_r``'s product
    all-gathered and reduce-scattered. A period's forward collectives
    run again under remat, but a period ending in its MLP's all-reduce
    without a post-norm (the backward saved its output). The
    vocab-split embedding, logits and loss."""
    calls = dict.fromkeys(ma.OPS, 0)
    nbytes = dict.fromkeys(calls, 0)
    t = b * s
    act = m * t * cfg.d_model * elt
    again = 1 + cfg.remat

    def add(op, n, k=1):
        calls[op] += k
        nbytes[op] += k * n

    for _ in range(cfg.n_periods):
        for spec in cfg.period:
            if spec.mixer == "rwkv":
                d = t * cfg.d_model * elt
                add("all_reduce", act, 1 + again)               # time mix
                add("all_gather", d, 3 * again)
                add("reduce_scatter", m * d, 3)
                add("all_reduce", act, 1 + again)               # channel mix
                add("all_gather", d, again)
                add("reduce_scatter", m * d)
                continue
            hd = cfg.resolved_head_dim
            for width, k in ((cfg.n_heads, 1), (cfg.n_kv_heads, 2)):
                add("all_gather", t * width * hd * elt, k * again)
                add("reduce_scatter", m * t * width * hd * elt, k)
            add("all_reduce", act, 2 * (1 + again))     # attention, MLP
        if cfg.remat and not cfg.post_block_norm and spec.ffn == "mlp":
            add("all_reduce", act, -1)
    add("all_reduce", act, 2)
    add("all_max", m * t * 4)
    add("all_reduce", m * t * 4, 2)
    return calls, nbytes


@pytest.mark.parametrize("name,remat", [
    ("gemma2_m8", False), ("gemma2_h6_m4", True), ("rwkv_m8", False),
    ("rwkv_h2_m4", True)])
def test_head_split_counters_equal_the_layer_list(name, remat):
    arch, over, m = FORWARD[name]
    cfg = dataclasses.replace(_cfg(arch, over), remat=remat)
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
# The train step on 2x2 and the serving steps on 1x4, against JAX
# ---------------------------------------------------------------------------

def test_head_split_train_steps_match_jax_2x2(jax_cases):
    want = jax_cases["train"]
    run = tfc.port_train_2x2("gemma2-2b", TRAIN, want)
    tc = run[0]
    h, kvh, hd = (tc.model.n_heads, tc.model.n_kv_heads,
                  tc.model.resolved_head_dim)
    assert (h % 2, kvh % 2, h * hd % 2, kvh * hd % 2) == (1, 1, 0, 0)
    tfc.check_train_2x2(want, *run, rtol=RTOL)


@pytest.mark.parametrize("name", list(SERVE))
def test_head_split_serving_steps_match_jax(jax_cases, name):
    arch, over = SERVE[name]
    cfg = _cfg(arch, over)
    heads = cfg.rwkv_n_heads if cfg.family == "ssm" else cfg.n_heads
    assert heads % 4
    tfc.check_serving_1xm(arch, "1x4", jax_cases[name], RTOL, cfg=cfg)


# ---------------------------------------------------------------------------
# Seeded faults, the dry-run, what still raises
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _sliced_gather_backward():
    """The all-gather's backward as a plain slice: each shard keeps its
    own copy's gradient of its block, unsummed."""
    real = ma._AllGather.backward

    def sliced(ctx, grad):
        m = ctx.axis.size
        return torch.stack([g.chunk(m, dim=ctx.dim)[i] for i, g in
                            enumerate(grad.unbind(0))]), None, None

    ma._AllGather.backward = staticmethod(sliced)
    try:
        yield
    finally:
        ma._AllGather.backward = real


@contextlib.contextmanager
def _neighbour_columns():
    """Each shard reads out the next block of columns of the heads it
    attends (its neighbour's columns of a cut head)."""
    real = layers._query_heads

    def shifted(cfg, axis, device):
        heads, cols = real(cfg, axis, device)
        width = heads.shape[1] * cfg.resolved_head_dim
        return heads, (cols + cols.shape[1]) % width

    layers._query_heads = shifted
    try:
        yield
    finally:
        layers._query_heads = real


@pytest.mark.parametrize("fault", ["sliced_backward", "neighbour_columns"])
def test_head_split_faults_fail_against_jax(jax_cases, fault):
    """The seeded faults of chip phase 29d on the CPU, gemma2 smoke at M
    = 8: each moves the gradients (or the logits) far past the bound the
    sharded run meets."""
    cfg, m, params, want = _forward_case(jax_cases, "gemma2_m8")
    tokens, labels, _ = _inputs(cfg)
    if fault == "neighbour_columns":
        with _neighbour_columns(), torch.no_grad():
            logits, _ = transformer.forward(shard_params(params, cfg, m), cfg,
                                            tokens,
                                            model_axis=StackModelAxis(m,
                                                                      "cpu"))
        err = np.abs(torch.cat(list(logits), -1).numpy()
                     - want["logits"]).max() / np.abs(want["logits"]).max()
        assert err > 100 * RTOL, err
        return
    with _sliced_gather_backward():
        *_, grads = tfc.tp_loss_and_grads(params, cfg, m, tokens, labels,
                                          StackModelAxis(m, "cpu"))
    got = tree_mod.flatten_with_paths(grads)
    err = max(np.abs(got[k].numpy() - want[f"g/{k}"]).max()
              / max(np.abs(want[f"g/{k}"]).max(), 1e-3) for k in got)
    assert err > 100 * RTOL, err


@pytest.mark.parametrize("arch,mesh_name", [
    ("gemma2-2b", "16x16"), ("phi3-medium-14b", "16x16"),
    ("qwen1.5-32b", "16x16"), ("rwkv6-3b", "16x16"),
    ("whisper-large-v3", "16x8")])
def test_head_split_dryrun_traces_full_configs(arch, mesh_name):
    """One device of the pod mesh on ``meta``: the full config's decode
    step traces, its model-axis collectives those of
    ``tp_serving_collectives`` (one device's calls, 1/M of the stack's
    bytes)."""
    mesh = parse_mesh(mesh_name, pods=True)
    n, m = mesh.n_nodes, mesh.model
    cfg = configs.get_config(arch)
    heads = cfg.rwkv_n_heads if cfg.family == "ssm" else cfg.n_heads
    assert heads % m
    rec = dryrun.build_case(arch, "decode_32k", mesh_name, "sdm-dsgd",
                            "fixedk_packed", "", verbose=False)
    assert rec["status"] == "ok" and rec["n_devices"] == n * m
    rows = -(-shapes.SHAPES["decode_32k"].global_batch // n)
    tp = tp_serving_collectives(cfg, m, rows, 1, "decode", torch.bfloat16)
    ops = {}
    for op, name in dryrun.HLO_NAMES.items():     # all_max: an all-reduce
        if tp[op]["calls"]:
            ops[name] = ops.get(name, 0) + tp[op]["calls"]
    assert rec["collective_ops"] == ops
    model_bytes = sum(v for k, v in rec["collective_bytes"].items()
                      if k not in ("total", "collective-permute"))
    assert model_bytes * m == sum(v["bytes"] for v in tp.values())


def test_head_split_2x16_bucket_planes_and_split_plan_match_jax():
    """Chip phase 29b's cell, gemma2-2b x 4 at full width on ``2x16``,
    from shapes alone: the state's bucket planes and their split plan
    equal JAX's on an abstract ``2x16`` mesh. The ``wk`` / ``wv`` lane of
    1024 splits to 64 columns a device, under the gather-pack kernel's
    block of 128: the plan splits the lane, the kernel's blocks run over
    each node's whole plane."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import compat, configs as jconfigs
    from repro.core.sdm_dsgd import SDMConfig as JSDMConfig
    from repro.train import steps as jsteps
    from repro_torch.core.sdm_dsgd import SDMConfig

    kw = dict(p=0.2, theta=0.5, gamma=1e-3, sigma=1.0, clip_c=1e-4,
              compressor="fixedk:128")
    cfg = dataclasses.replace(configs.get_config("gemma2-2b"), n_layers=4)
    jcfg = dataclasses.replace(jconfigs.get_config("gemma2-2b"), n_layers=4)
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig(**kw))
    jtc = jsteps.DistributedTrainConfig(model=jcfg, sdm=JSDMConfig(**kw),
                                        param_dtype=jnp.bfloat16)
    mesh = parse_mesh("2x16")
    jmesh = compat.abstract_mesh((2, 16), ("data", "model"))
    shapes, jshapes = (steps.state_shape_dtype(tc, mesh),
                       jsteps.state_shape_dtype(jtc, jmesh))
    plan, jplan = (steps.state_shardings(tc, mesh),
                   jsteps.state_shardings(jtc, jmesh))
    lanes = [tuple(p.shape) for p in shapes.s]
    assert lanes == [tuple(p.shape) for p in jshapes.s]
    assert sorted(t[-1] for t in lanes) == [128, 1024, 2048, 9216]
    assert [tuple(p) for p in plan.s] == [tuple(p.spec) for p in jplan.s]
    assert sum(p[-1] == "model" for p in plan.s) == 3   # lanes split 16 ways


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3",
                                  "llama-3.2-vision-11b", "rwkv6-3b"])
def test_head_split_launcher_runs_each_smoke_config_at_m8(arch, capsys):
    """``launch.train --mesh 1x8 --device cpu``: the smoke configs' 4
    heads over 8 shards through ``make_distributed_train``, with the
    split inside a head's all-gathers counted a step."""
    from repro_torch.launch import train as train_mod

    train_mod.main(["--arch", arch, "--smoke", "--steps", "2", "--device",
                    "cpu", "--mesh", "1x8"])
    out = capsys.readouterr().out
    losses = re.findall(r"^step +\d+ loss (\S+) .*all_gather (\d+)", out,
                        re.MULTILINE)
    assert len(losses) == 2, out[-2000:]
    assert all(np.isfinite(float(v)) and int(g) > 0 for v, g in losses)


def test_head_split_still_refuses_ragged_offsets_and_overrides():
    """What remains refused under a model axis whose heads M cuts:
    ragged offsets (no reference step: JAX's ``make_decode_fn`` passes
    none) and rule overrides (item 5d), each naming ROADMAP."""
    cfg = _cfg("gemma2-2b", H6)
    mesh = parse_mesh("1x4")
    _, rules = steps.make_decode_fn(cfg, mesh, device="cpu")
    cache = shard_cache(transformer.init_cache(cfg, 2, 8, torch.float32,
                                               "cpu"), cfg, rules)
    assert cache.slots["0"].k.shape[1] == 4          # split by positions
    zeros = torch.zeros(2, dtype=torch.long)
    params = shard_params(transformer.init_params(cfg, device="cpu"), cfg, 4)
    with pytest.raises(NotImplementedError, match="ragged.*ROADMAP"):
        transformer.decode_step(params, cfg, zeros, cache, offsets=zeros,
                                model_axis=StackModelAxis(4, "cpu"))
    with pytest.raises(ValueError, match="ROADMAP.*5d"):
        steps.make_prefill_fn(cfg, mesh, device="cpu",
                              rule_overrides={"seq": "model"})
    whole = unshard_cache(cache, cfg, rules)
    assert whole.slots["0"].k.shape == (1, 2, 8, 2, 32)    # JAX's layout
