"""PyTorch port: tensor parallelism over the ``model`` axis for the ssm
family (rwkv6-3b: the rwkv time mix and channel mix), against JAX.

- The forward: ``transformer.forward`` + ``lm_loss`` and their gradients
  over M = 2 and M = 4 shards against the JAX package's unsharded
  forward on rwkv6's smoke config (4 heads of 32; ``decay_bias`` /
  ``bonus_u`` redrawn as small normals). The time mix splits by heads
  (``w_r``, ``w_k``, ``w_v``, ``w_decay``, ``w_g`` by columns,
  ``decay_bias`` / ``bonus_u`` by heads, ``w_out`` by rows); the channel
  mix's ``w_k`` / ``w_v`` by ``mlp``, ``w_r``'s product all-gathered. A
  variant: d_ff 258 at M = 4 (``w_k`` / ``w_v`` whole, ``w_r`` split).
  Tolerances are ``test_torch_tp_mamba.py``'s: the loss at 2e-6
  relative, the logits at 1e-4 absolute, the gradients at 1e-4 of each
  leaf's scale, the recurrent states and serving logits at 2e-5 of
  their scale. JAX runs in subprocesses
  (``tests/helpers/tp_family_check.py``), started together.
- The model-axis counters equal a count derived here from the layer list
  and ``model_axis.tp_collectives`` (remat too).
- Three train steps on ``2x2`` against JAX's ``make_distributed_train``
  on 4 faked devices: losses, final ``x`` / ``s``, the node-axis
  permutes' count and per-device payload shapes.
- ``make_prefill_fn`` + 4 steps of ``make_decode_fn`` on ``1x2`` and
  ``1x4`` against JAX's (the WKV states split by heads), the counters
  every step; ``RWKVState`` ``shard_cache`` round trips; the dry-run on
  ``1x4`` / ``2x2``; the heads that M does not divide still raise; a
  seeded fault (the last shard's ``w_out`` partial dropped from the time
  mix's all-reduce) fails the comparison with JAX.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_family_check as tfc  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import (params_from_jax, shard_cache,  # noqa: E402
                                 unshard_cache)
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import rwkv, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCH = "rwkv6-3b"
VARIANTS = {"smoke": {}, "dff258": {"d_ff": 258}}
# test_torch_tp_mamba.py's bounds for the same comparisons
LOGIT_ATOL, GRAD_RTOL, STATE_RTOL = 1e-4, 1e-4, 2e-5


def _cfg(variant):
    return dataclasses.replace(configs.get_smoke_config(ARCH),
                               **VARIANTS[variant])


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax_tp_rwkv")
    procs = {"train": (tfc.start("train", ARCH, "0", tmp / "train.npz"),
                       tmp / "train.npz"),
             "serve": (tfc.start("serve", ARCH, "1x2,1x4",
                                 tmp / "serve.npz"), tmp / "serve.npz"),
             "forward": (tfc.start("forward", ARCH, json.dumps(VARIANTS),
                                   tmp / "forward.npz"),
                         tmp / "forward.npz")}
    return {k: tfc.collect(p, path) for k, (p, path) in procs.items()}


def _forward_case(jax_cases, variant):
    want = {k[len(variant) + 1:]: v for k, v in jax_cases["forward"].items()
            if k.startswith(variant + "/")}
    cfg = _cfg(variant)
    params = params_from_jax({k[2:]: v for k, v in want.items()
                              if k.startswith("p/")}, cfg, device="cpu")
    return cfg, params, want


@pytest.mark.parametrize("variant,m", [("smoke", 2), ("smoke", 4),
                                       ("dff258", 4)])
def test_tp_rwkv_forward_loss_and_grads_match_jax(jax_cases, variant, m):
    cfg, params, want = _forward_case(jax_cases, variant)
    jg = {k[2:]: v for k, v in want.items() if k.startswith("g/")}
    tokens, labels = tfc.forward_inputs(cfg.vocab_size)
    axis = StackModelAxis(m, "cpu")
    shards, logits, aux, loss, grads = tfc.tp_loss_and_grads(
        params, cfg, m, torch.from_numpy(tokens), torch.from_numpy(labels),
        axis)
    d, h, n = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size
    mix = shards["blocks"]["0"]["time_mix"]
    assert mix["w_r"].shape == (2, m, d, h * n // m)
    assert mix["decay_bias"].shape == (2, m, h // m, n)
    assert mix["w_out"].shape == (2, m, d // m, d)
    assert mix["mix_r"].shape == (2, d)                 # replicated
    cm = shards["blocks"]["0"]["channel_mix"]
    assert cm["w_r"].shape == (2, m, d, d // m)
    if cfg.d_ff % m:                                    # the mlp fallback
        assert cm["w_k"].shape == (2, d, cfg.d_ff)
    else:
        assert cm["w_v"].shape == (2, m, cfg.d_ff // m, d)
    assert logits.shape == (m, 2, 24, cfg.padded_vocab // m)
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]),
                               rtol=2e-6)
    whole = torch.cat(list(logits.detach()), dim=-1).numpy()
    # the witness: the unsharded forward with the heads and d_ff reversed
    # (the same function, its products summed in another order) against
    # JAX, read beside the sharded one; both sit ~7e-6 from JAX (the f32
    # floor of this forward: each package ~7e-6 from float64), so an
    # order alone stays far under the bound
    with torch.no_grad():
        wit, _ = transformer.forward(tfc.reversed_order(params, cfg), cfg,
                                     torch.from_numpy(tokens))
    wit = float(np.abs(wit.numpy() - want["logits"]).max())
    err = float(np.abs(whole - want["logits"]).max())
    assert wit <= LOGIT_ATOL and err <= LOGIT_ATOL, (err, wit)
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(jg) == sorted(got)
    for k in jg:
        tfc.close(got[k].numpy(), jg[k], GRAD_RTOL, k)


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient, counted here from the
    layer list. Per time mix: the normed input's copy-in and ``w_out``'s
    all-reduce (again under remat). Per channel mix: the input's
    copy-in; with a split ``w_k`` the ``w_v`` partials' all-reduce, with
    a split ``w_r`` its product's all-gather (both again under remat:
    the block's last product saves both) and reduce-scatter. The
    vocab-split embedding, logits and loss."""
    calls = dict.fromkeys(("all_reduce", "all_gather", "reduce_scatter",
                           "all_max"), 0)
    nbytes = dict.fromkeys(calls, 0)
    t = b * s
    act = m * t * cfg.d_model * elt
    again = 1 + cfg.remat

    def add(op, n, k=1):
        calls[op] += k
        nbytes[op] += k * n

    for _ in range(cfg.n_periods):
        add("all_reduce", act, 1 + again)               # time mix
        add("all_reduce", act)                          # channel mix's f
        if cfg.d_ff % m == 0:
            add("all_reduce", act, again)
        add("all_gather", t * cfg.d_model * elt, again)
        add("reduce_scatter", m * t * cfg.d_model * elt)
    add("all_reduce", act, 2)
    add("all_max", m * t * 4)
    add("all_reduce", m * t * 4, 2)
    return calls, nbytes


@pytest.mark.parametrize("variant,m,remat", [
    ("smoke", 2, False), ("smoke", 4, True), ("dff258", 4, False),
    ("dff258", 2, True)])
def test_rwkv_model_axis_counters_equal_the_layer_list(variant, m, remat):
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

def test_tp_rwkv_train_steps_match_jax_2x2(jax_cases):
    want = jax_cases["train"]
    run = tfc.port_train_2x2(ARCH, 0, want)
    tfc.check_train_2x2(want, *run, rtol=GRAD_RTOL)
    tc, params = run[:2]
    from repro_torch.core.plane import ParamPlane
    with steps.bucket_ctx(tc, 2):
        spec = ParamPlane.for_tree(params)
    flat = list(tree_mod.flatten_with_paths(params))
    d = tc.model.d_model
    members = {flat[i].rsplit("/", 1)[-1] for b in spec.buckets
               if b.key == ("model", d) for i in b.leaves}
    # heads_flat and mlp columns of width d share a bucket; decay_bias /
    # bonus_u end in None, w_out / w_v in embed: the flat plane
    assert {"w_r", "w_k", "w_v", "w_g", "w_decay"} <= members
    assert not {"decay_bias", "bonus_u", "w_out"} & members


@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_tp_rwkv_serving_steps_match_jax(jax_cases, mesh_name):
    tfc.check_serving_1xm(ARCH, mesh_name, jax_cases["serve"], STATE_RTOL)


def test_tp_rwkv_dropped_w_out_partial_fails_against_jax(jax_cases,
                                                        monkeypatch):
    """The seeded fault of chip phase 28d on the CPU: the last shard's
    ``w_out`` partial dropped from the time mix's all-reduce moves the
    logits far past the bound the sharded forward meets."""
    cfg, params, want = _forward_case(jax_cases, "smoke")
    tokens, _ = tfc.forward_inputs(cfg.vocab_size)
    real = rwkv.rwkv_time_mix

    def broken(p, c, x, state, model_axis=None):
        return real(p, c, x, state, None if model_axis is None
                    else tfc.LastShardDropped(model_axis))

    monkeypatch.setattr(rwkv, "rwkv_time_mix", broken)
    axis = StackModelAxis(2, "cpu")
    from repro_torch.convert import shard_params
    with torch.no_grad():
        logits, _ = transformer.forward(shard_params(params, cfg, 2), cfg,
                                        torch.from_numpy(tokens),
                                        model_axis=axis)
    err = np.abs(torch.cat(list(logits), -1).numpy() - want["logits"]).max()
    assert err > 100 * LOGIT_ATOL, err


# ---------------------------------------------------------------------------
# The WKV states' layout, the dry-run, what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name,seq,decode", [
    ("1x2", False, False), ("1x4", False, True), ("2x2", True, True)])
def test_rwkv_state_shard_cache_round_trip(mesh_name, seq, decode):
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
    assert isinstance(st, rwkv.RWKVState)
    h, n, d = cfg.rwkv_n_heads, cfg.rwkv_head_size, cfg.d_model
    assert st.wkv.shape == (2, m, 2, h // m, n, n)
    assert st.att_shift.shape == st.ffn_shift.shape == (2, 2, d)
    back = unshard_cache(sharded, cfg, rules)
    for a, b in zip(cache.slots["0"], back.slots["0"]):
        assert torch.equal(a, b)
    whole = cache.slots["0"]
    for i in range(m):
        one = shard_cache(cache, cfg, rules, index=i).slots["0"]
        assert torch.equal(one.wkv[:, 0],
                           whole.wkv[:, :, i * h // m:(i + 1) * h // m])
        assert torch.equal(one.att_shift, whole.att_shift)


@pytest.mark.parametrize("mesh_name,shape", [
    ("1x4", "train_4k"), ("2x2", "prefill_32k"), ("1x4", "decode_32k"),
    ("2x2", "train_4k")])
def test_dryrun_traces_rwkv_on_nxm(mesh_name, shape):
    rec = tfc.check_dryrun_nxm(ARCH, mesh_name, shape, seq_len=32)
    assert rec["collective_ops"]["all-gather"] > 0      # the w_r blocks


def test_rwkv_heads_that_m_does_not_divide_still_raise(capsys):
    """Heads that M does not divide now split inside a head (their values
    against JAX: ``test_torch_tp_head_split.py``): rwkv6-smoke's 4 heads
    at M = 8 through the forward, the prefill step and the launcher (the
    WKV state by columns), rwkv6-3b's 40 at M = 16 through the dry-run.
    What still raises under such an axis: rule overrides (ROADMAP Queue
    1, item 5d)."""
    cfg = configs.get_smoke_config(ARCH)
    tok = torch.zeros(1, 4, dtype=torch.long)
    params = transformer.init_params(cfg, device="cpu")
    from repro_torch.convert import shard_params
    with torch.no_grad():
        logits, _ = transformer.forward(shard_params(params, cfg, 8), cfg,
                                        tok,
                                        model_axis=StackModelAxis(8, "cpu"))
    assert logits.shape == (8, 1, 4, cfg.padded_vocab // 8)
    assert torch.isfinite(logits).all()
    _, rules = steps.make_prefill_fn(cfg, parse_mesh("1x8"), device="cpu")
    st = shard_cache(transformer.init_cache(cfg, 2, 8, torch.float32, "cpu"),
                     cfg, rules).slots["0"]
    h, n = cfg.rwkv_n_heads, cfg.rwkv_head_size
    assert st.wkv.shape == (cfg.n_periods, 8, 2, h * n // 8, n)
    with pytest.raises(ValueError, match="ROADMAP.*5d"):
        steps.make_prefill_fn(cfg, parse_mesh("1x8"), device="cpu",
                              rule_overrides={"seq": "model"})
    train_mod.main(["--arch", ARCH, "--smoke", "--steps", "1",
                    "--device", "cpu", "--mesh", "1x8"])
    assert re.search(r"^step +0 loss [\d.]+", capsys.readouterr().out,
                     re.MULTILINE)
    rec = dryrun.build_case(ARCH, "decode_32k", "16x16", "sdm-dsgd",
                            "fixedk_packed", "", verbose=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
