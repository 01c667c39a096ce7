"""PyTorch port: tensor parallelism over the ``model`` axis for the audio
and vlm families (whisper-large-v3: encoder, cross-attention in every
layer, learned positions, a tied embedding; llama-3.2-vision-11b:
cross-attention in slot 0 of each period, GQA), against JAX.

- The forward: ``transformer.forward`` + ``lm_loss`` and their gradients
  (the encoder's and ``pos_embed``'s included) over M = 2 and M = 4
  shards, on a seeded context of distinct rows
  (``tp_family_check.context_input``), against the JAX package's
  unsharded forward on the smoke configs. Cross-attention takes its
  queries from each shard's ``wq`` block and K / V from each shard's
  ``wk`` / ``wv`` block applied to the replicated context (through *f*:
  its gradient flows back into whisper's encoder); llama-vision's 2 KV
  heads at M = 4 are all-gathered, and a head_dim 33 variant at M = 4
  leaves ``wk`` / ``wv`` whole (66 columns). The encoder's layers split
  as the decoder's; ``pos_embed`` and the encoder's final norm are
  replicated. Tolerances are ``test_torch_tp_mamba.py``'s: the loss at
  2e-6 relative, the logits at 1e-4 absolute, the gradients at 1e-4 of
  each leaf's scale, serving logits and caches at 2e-5 of their scale.
  JAX runs in subprocesses (``tests/helpers/tp_family_check.py``),
  started together.
- The model-axis counters equal a count derived here from the layer list
  and ``model_axis.tp_collectives`` (remat too).
- Three train steps on ``2x2`` against JAX's ``make_distributed_train``
  on 4 faked devices, the seeded context split over the nodes (whisper
  whole; llama-vision's first 2 slots: the cross slot and a self-
  attention slot).
- ``make_prefill_fn`` + 4 steps of ``make_decode_fn`` on ``1x2`` and
  ``1x4`` against JAX's (prefill encodes the raw context, decode takes it
  encoded), the counters every step; the dry-run on ``1x4`` / ``2x2``;
  the heads that M does not divide still raise; a seeded fault (one
  shard's cross-attention K / V block zeroed) fails the comparison with
  JAX.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_family_check as tfc  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import params_from_jax, shard_params  # noqa: E402
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-11b"
VARIANTS = {WHISPER: {"smoke": {}},
            VISION: {"smoke": {}, "hd33": {"head_dim": 33}}}
TRAIN_SLOTS = {WHISPER: 0, VISION: 2}
# test_torch_tp_mamba.py's bounds for the same comparisons
LOGIT_ATOL, GRAD_RTOL, STATE_RTOL = 1e-4, 1e-4, 2e-5


def _cfg(arch, variant="smoke"):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               **VARIANTS[arch][variant])


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("jax_tp_encoder")
    procs = {}
    for arch in (WHISPER, VISION):
        for kind, arg in (("train", str(TRAIN_SLOTS[arch])),
                          ("serve", "1x2,1x4"),
                          ("forward", json.dumps(VARIANTS[arch]))):
            path = tmp / f"{kind}_{arch}.npz"
            procs[arch, kind] = (tfc.start(kind, arch, arg, path), path)
    return {k: tfc.collect(p, path) for k, (p, path) in procs.items()}


def _forward_case(jax_cases, arch, variant):
    want = {k[len(variant) + 1:]: v
            for k, v in jax_cases[arch, "forward"].items()
            if k.startswith(variant + "/")}
    cfg = _cfg(arch, variant)
    params = params_from_jax({k[2:]: v for k, v in want.items()
                              if k.startswith("p/")}, cfg, device="cpu")
    tokens, labels = tfc.forward_inputs(cfg.vocab_size)
    ctx = torch.from_numpy(tfc.context_input(cfg, len(tokens)))
    return cfg, params, want, torch.from_numpy(tokens), \
        torch.from_numpy(labels), ctx


@pytest.mark.parametrize("arch,variant,m", [
    (WHISPER, "smoke", 2), (WHISPER, "smoke", 4), (VISION, "smoke", 2),
    (VISION, "smoke", 4), (VISION, "hd33", 4)])
def test_tp_encoder_forward_loss_and_grads_match_jax(jax_cases, arch,
                                                     variant, m):
    cfg, params, want, tokens, labels, ctx = _forward_case(jax_cases, arch,
                                                           variant)
    jg = {k[2:]: v for k, v in want.items() if k.startswith("g/")}
    axis = StackModelAxis(m, "cpu")
    shards, logits, aux, loss, grads = tfc.tp_loss_and_grads(
        params, cfg, m, tokens, labels, axis, context=ctx)
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    cross = shards["blocks"]["0"]["cross"]
    assert cross["wq"].shape == (cfg.n_periods, m, cfg.d_model,
                                 cfg.n_heads * hd // m)
    if kvh * hd % m:                                    # wk / wv whole
        assert cross["wk"].shape == (cfg.n_periods, cfg.d_model, kvh * hd)
    else:
        assert cross["wk"].shape == (cfg.n_periods, m, cfg.d_model,
                                     kvh * hd // m)
    if cfg.has_encoder:
        enc = shards["encoder"]
        assert enc["layers"]["attn"]["wq"].shape == (
            cfg.n_encoder_layers, m, cfg.d_model, cfg.n_heads * hd // m)
        assert enc["final_norm"].shape == (cfg.d_model,)
        assert shards["pos_embed"].shape == (cfg.max_position_embeddings,
                                             cfg.d_model)
    assert logits.shape == (m, 2, 24, cfg.padded_vocab // m)
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]),
                               rtol=2e-6)
    whole = torch.cat(list(logits.detach()), dim=-1).numpy()
    np.testing.assert_allclose(whole, want["logits"], atol=LOGIT_ATOL)
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(jg) == sorted(got)
    for k in jg:
        tfc.close(got[k].numpy(), jg[k], GRAD_RTOL, k)


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient, counted here from the
    layer list. Per encoder layer (over the context's rows, not
    recomputed): the attention's copy-in and all-reduce, K / V handled
    as in a self-attention block, the MLP's copy-in and all-reduce. Per
    decoder slot: the self-attention block as ``test_torch_tp_train.py``
    counts it; per cross-attention block the queries' copy-in, the
    output's all-reduce (again under remat) and, with a split ``wk``,
    the context's copy-in (only where it has a gradient: whisper's
    encoder output) and, where M does not divide the KV heads, K / V
    all-gathered (again under remat) and reduce-scattered, with ``wk``
    whole K's and V's copy-in; per MLP block a copy-in and an all-reduce
    (again under remat unless it ends the period). The vocab-split
    embedding, logits and loss."""
    calls = dict.fromkeys(("all_reduce", "all_gather", "reduce_scatter",
                           "all_max"), 0)
    nbytes = dict.fromkeys(calls, 0)
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    t, tc = b * s, b * (cfg.encoder_seq if cfg.has_encoder
                        else cfg.n_image_tokens)
    split_kv = kvh * hd % m == 0

    def add(op, n, k=1):
        calls[op] += k
        nbytes[op] += k * n

    def kv(rows, again):
        kvb = rows * kvh * hd * elt
        if split_kv and kvh % m:
            add("all_gather", kvb, 2 * again)
            add("reduce_scatter", m * kvb, 2)
        elif not split_kv:
            add("all_reduce", m * kvb, 2)

    for _ in range(cfg.n_encoder_layers):
        add("all_reduce", m * tc * cfg.d_model * elt, 4)
        kv(tc, 1)
    again = 1 + cfg.remat
    act = m * t * cfg.d_model * elt
    for _ in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            add("all_reduce", act, 1 + again)               # self-attention
            kv(t, again)
            if spec.cross_attn:
                add("all_reduce", act, 1 + again)
                if split_kv and cfg.has_encoder:
                    add("all_reduce", m * tc * cfg.d_model * elt)
                kv(tc, again)
            last = si == len(cfg.period) - 1
            add("all_reduce", act, 1 + (1 if last else again))
    add("all_reduce", act, 2)
    add("all_max", m * t * 4)
    add("all_reduce", m * t * 4, 2)
    return calls, nbytes


@pytest.mark.parametrize("arch,variant,m,remat", [
    (WHISPER, "smoke", 2, False), (WHISPER, "smoke", 4, True),
    (VISION, "smoke", 2, True), (VISION, "smoke", 4, False),
    (VISION, "hd33", 4, True)])
def test_encoder_model_axis_counters_equal_the_layer_list(arch, variant, m,
                                                          remat):
    cfg = dataclasses.replace(_cfg(arch, variant), remat=remat)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    ctx = torch.from_numpy(tfc.context_input(cfg, 2))
    axis = StackModelAxis(m, "cpu")
    tfc.tp_loss_and_grads(params, cfg, m, tokens, tokens, axis, context=ctx)
    calls, nbytes = _derived_counts(cfg, m, 2, 24, 4)
    assert axis.calls == calls and axis.bytes == nbytes
    formula = tp_collectives(cfg, m, 2, 24, torch.float32)
    assert {op: v["calls"] for op, v in formula.items()} == calls
    assert {op: v["bytes"] for op, v in formula.items()} == nbytes


# ---------------------------------------------------------------------------
# The train step on 2x2 and the serving steps, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_tp_encoder_train_steps_match_jax_2x2(jax_cases, arch):
    want = jax_cases[arch, "train"]
    run = tfc.port_train_2x2(arch, TRAIN_SLOTS[arch], want)
    tfc.check_train_2x2(want, *run, rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
def test_tp_encoder_serving_steps_match_jax(jax_cases, arch, mesh_name):
    tfc.check_serving_1xm(arch, mesh_name, jax_cases[arch, "serve"],
                          STATE_RTOL)


@contextlib.contextmanager
def cross_kv_zeroed():
    """The seeded fault of chip phase 28d on the CPU: the last shard's
    block of the cross-attention K / V zeroed (a split ``wk``)."""
    real = layers._tp_project

    def broken(params, cfg, x, axis, kv_source=None):
        residual, q, k, v, kv = real(params, cfg, x, axis, kv_source)
        if kv_source is not None and kv != "whole":
            k, v = (torch.cat([t[:-1], torch.zeros_like(t[-1:])])
                    for t in (k, v))
        return residual, q, k, v, kv

    layers._tp_project = broken
    try:
        yield
    finally:
        layers._tp_project = real


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_tp_cross_kv_shard_zeroed_fails_against_jax(jax_cases, arch):
    cfg, params, want, tokens, _, ctx = _forward_case(jax_cases, arch,
                                                      "smoke")
    with cross_kv_zeroed(), torch.no_grad():
        logits, _ = transformer.forward(shard_params(params, cfg, 2), cfg,
                                        tokens, context=ctx,
                                        model_axis=StackModelAxis(2, "cpu"))
    err = np.abs(torch.cat(list(logits), -1).numpy() - want["logits"]).max()
    assert err > 100 * LOGIT_ATOL, err


# ---------------------------------------------------------------------------
# The dry-run and what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name,shape", [
    (WHISPER, "1x4", "train_4k"), (WHISPER, "2x2", "prefill_32k"),
    (WHISPER, "1x4", "decode_32k"), (VISION, "2x2", "train_4k"),
    (VISION, "1x4", "prefill_32k"), (VISION, "2x2", "decode_32k")])
def test_dryrun_traces_encoder_families_on_nxm(arch, mesh_name, shape):
    rec = tfc.check_dryrun_nxm(arch, mesh_name, shape, seq_len=32)
    assert rec["collective_ops"]["all-reduce"] > 0


def test_encoder_heads_that_m_does_not_divide_still_raise():
    """Heads that M does not divide now split inside a head (their values
    against JAX: ``test_torch_tp_head_split.py``): the smoke configs' 4
    heads at M = 8 through the forward (encoder, cross-attention and
    decoder) and the decode step; whisper-large-v3's 20 at M = 8 and 16
    through the dry-run. What still raises under such an axis: ragged
    offsets (ROADMAP Queue 1) and rule overrides (item 5d)."""
    tok = torch.zeros(2, 4, dtype=torch.long)
    for arch in (WHISPER, VISION):
        cfg = configs.get_smoke_config(arch)
        params = shard_params(transformer.init_params(cfg, device="cpu"),
                              cfg, 8)
        ctx = torch.from_numpy(tfc.context_input(cfg, 2))
        axis = StackModelAxis(8, "cpu")
        with torch.no_grad():
            logits, _ = transformer.forward(params, cfg, tok, context=ctx,
                                            model_axis=axis)
        assert logits.shape == (8, 2, 4, cfg.padded_vocab // 8)
        assert torch.isfinite(logits).all() and axis.calls["all_gather"]
        _, rules = steps.make_decode_fn(cfg, parse_mesh("1x8"),
                                        device="cpu")
        from repro_torch.convert import shard_cache
        cache = shard_cache(transformer.init_cache(cfg, 2, 8, torch.float32,
                                                   "cpu"), cfg, rules)
        zeros = torch.zeros(2, dtype=torch.long)
        with torch.no_grad():
            enc = transformer.encode_context(params, cfg, ctx,
                                             model_axis=axis)
        with pytest.raises(NotImplementedError, match="ragged.*ROADMAP"):
            transformer.decode_step(params, cfg, zeros, cache, context=enc,
                                    offsets=zeros, model_axis=axis)
        with pytest.raises(ValueError, match="ROADMAP.*5d"):
            steps.make_decode_fn(cfg, parse_mesh("1x8"), device="cpu",
                                 rule_overrides={"seq": "model"})
    for mesh, n in (("16x8", 128), ("16x16", 256)):
        rec = dryrun.build_case(WHISPER, "decode_32k", mesh, "sdm-dsgd",
                                "fixedk_packed", "", verbose=False)
        assert rec["status"] == "ok" and rec["n_devices"] == n
