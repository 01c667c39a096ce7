"""PyTorch port: tensor parallelism over the ``model`` axis, against JAX.

- The forward: ``transformer.forward`` + ``lm_loss`` and their gradients
  over M = 2 and M = 4 shards (``convert.shard_params``, a
  ``StackModelAxis`` on the CPU) equal the JAX package's unsharded
  forward on gemma2-2b's smoke config (parameters carried over by
  ``convert.params_from_jax``), at ``test_torch_lm_train.py``'s
  tolerances. At M = 4 the 2 KV heads' 64 columns split into quarters of
  a head, so every shard all-gathers K / V; a 1-KV-head variant with
  head_dim 33 leaves ``wk`` / ``wv`` whole (the divisibility fallback).
- The model-axis counters equal a count derived here from the layer
  list (and ``model_axis.tp_collectives``).
- Shard width: under a dispatch mode no matmul of the forward or the
  backward takes an operand as wide as a whole split weight.
- Three train steps on ``2x2`` (2 nodes x 2 shards) against the JAX
  package's ``make_distributed_train`` on a faked 4-device ``2x2`` mesh
  (each case in a subprocess this test starts, XLA_FLAGS before jax
  imports): sdm-dsgd on ``fixedk_packed`` with sigma > 0, sdm-dsgd on
  ``bernoulli``, sdm-dsgd-fused on ``fixedk_rows``. Losses at rtol 1e-5,
  the state as ``test_torch_lm_train.py`` holds it, and the transport's
  counters equal the node-axis collective-permutes of JAX's compiled
  step: one per bucket plane and round, each payload of the port's
  shape with a bucket's lane split over the model axis as the step's
  split plan says.
- The buckets change the draws: the ``2x2`` run departs from the ``2``
  run (no model axis, one flat plane) exactly as JAX's does.
- ``launch.train --mesh 2x2 --device cpu`` prints the buckets, finite
  losses and the model-axis collectives a step.
"""
import dataclasses
import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

ARCH = "gemma2-2b"
NODES, MODEL, STEPS, BATCH, SEQ = 2, 2, 3, 4, 32
CASES = {
    "fixedk_packed": ("sdm-dsgd", dict(p=0.2, theta=0.5, gamma=1e-2,
                                       sigma=0.1, clip_c=1.0,
                                       compressor="fixedk:8")),
    "bernoulli": ("sdm-dsgd", dict(p=0.3, theta=0.5, gamma=1e-2, sigma=0.0,
                                   clip_c=1.0, mode="bernoulli")),
    "fused_rows": ("sdm-dsgd-fused", dict(p=0.2, theta=0.5, gamma=1e-2,
                                          sigma=0.0, clip_c=1.0,
                                          mode="fixedk_rows")),
}
MESHES = {"2x2": ("fixedk_packed", "bernoulli", "fused_rows"),
          "2": ("fixedk_packed",)}
SUBPROCESS_TIMEOUT = 300


def _flat(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _jax_main(case: str, mesh_name: str, out_path: str) -> None:
    """One case of the JAX package's train step on 4 faked CPU devices:
    its losses, state and the node-axis collective-permutes (per-device
    payload shapes) of its compiled step."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.core.sdm_dsgd import SDMConfig
    from repro.data import TokenStream
    from repro.launch.mesh import make_mesh_by_name
    from repro.train import steps

    method, kw = CASES[case]
    cfg = configs.get_smoke_config(ARCH)
    mesh = make_mesh_by_name(mesh_name)
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig(**kw),
                                      topology="ring", method=method,
                                      param_dtype=jnp.float32)
    state = steps.init_distributed_state(tc, mesh, jax.random.PRNGKey(0))
    out = {f"init/{k}": v[0] for k, v in _flat(state.x).items()}
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=BATCH,
                         seq_len=SEQ, seed=0)
    batches = [tuple(jnp.asarray(a) for a in stream.batch_at(t))
               for t in range(STEPS)]
    step = jax.jit(steps.make_distributed_train(tc, mesh)).lower(
        state, *batches[0]).compile()
    shapes = []
    for line in step.as_text().splitlines():
        if "ppermute" not in line or not re.search(
                r" collective-permute(-start)?\(", line):
            continue
        m = re.search(r"= *\(?(\w+)\[([\d,]*)\]", line)
        shapes.append([m.group(1)] + [int(d) for d in m.group(2).split(",")
                                      if d])
    losses = []
    want = step.input_shardings[0][0]
    for tokens, labels in batches:
        # the compiled step takes its state in the layout it was built for
        state, loss = step(jax.device_put(state, want), tokens, labels)
        losses.append(float(loss))
    out["losses"] = np.asarray(losses)
    out["payloads"] = np.asarray(
        [s[1:] + [0] * (3 - len(s[1:])) + [4 if s[0] == "f32" else 0]
         for s in shapes], dtype=np.int64).reshape(-1, 4)
    out.update({f"x/{k}": v for k, v in _flat(state.x).items()})
    out.update({f"s/{i}": np.asarray(v) for i, v in enumerate(state.s)})
    np.savez(out_path, **out)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main(*sys.argv[2:5])
    sys.exit(0)

torch = pytest.importorskip("torch")

from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import (params_from_jax, shard_params,  # noqa: E402
                                 unshard_params)
from repro_torch.core import transport as tr, wire_count  # noqa: E402
from repro_torch.core import plane as plane_mod, sdm_dsgd  # noqa: E402
from repro_torch.core.model_axis import (StackModelAxis,  # noqa: E402
                                         tp_collectives)
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402


# ---------------------------------------------------------------------------
# The forward over the shards
# ---------------------------------------------------------------------------

def _variant(name):
    cfg = configs.get_smoke_config(ARCH)
    if name == "kv1_hd33":         # wk / wv: 33 columns stay whole at M = 2
        cfg = dataclasses.replace(cfg, n_kv_heads=1, head_dim=33)
    return cfg


def _jax_variant(name):
    from repro import configs as jconfigs

    cfg = jconfigs.get_smoke_config(ARCH)
    if name == "kv1_hd33":
        cfg = dataclasses.replace(cfg, n_kv_heads=1, head_dim=33)
    return cfg


def _tp_loss_and_grads(params, cfg, m, tokens, labels, axis):
    shards = shard_params(params, cfg, m)
    leaves, struct = tree_mod.flatten(shards)
    mine = [v.requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      tokens, model_axis=axis)
    loss = transformer.lm_loss(logits, labels, cfg.vocab_size, aux,
                               model_axis=axis)
    grads = unshard_params(tree_mod.unflatten(
        struct, list(torch.autograd.grad(loss, mine))), cfg, m)
    return logits, loss, grads


@pytest.mark.parametrize("variant,m", [("smoke", 2), ("smoke", 4),
                                       ("kv1_hd33", 2)])
def test_tp_forward_loss_and_grads_match_jax(variant, m):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import transformer as jtf

    jcfg, cfg = _jax_variant(variant), _variant(variant)
    jparams = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)

    def jloss(p):
        logits, aux = jtf.forward(p, jcfg, jnp.asarray(tokens))
        return jtf.lm_loss(logits, jnp.asarray(labels), jcfg.vocab_size,
                           aux), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = params_from_jax(_flat(jparams), cfg, device="cpu")
    axis = StackModelAxis(m, "cpu")
    logits, loss, grads = _tp_loss_and_grads(
        params, cfg, m, torch.from_numpy(tokens), torch.from_numpy(labels),
        axis)
    assert logits.shape == (m, 2, 24, cfg.padded_vocab // m)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-6)
    whole = torch.cat(list(logits.detach()), dim=-1).numpy()
    np.testing.assert_allclose(whole, np.asarray(jlogits), rtol=0,
                               atol=1e-5 * float(np.abs(jlogits).max()))
    want = _flat(jg)
    got = tree_mod.flatten_with_paths(grads)
    assert sorted(want) == sorted(got)
    for k in want:
        scale = max(float(np.max(np.abs(want[k]))), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    assert sum(axis.calls.values()) > 0


def _derived_counts(cfg, m, b, s, elt):
    """The model-axis collectives of one gradient, counted here from the
    layer list: per attention block the input's copy-in (an all-reduce
    of its gradient) and the output's all-reduce, K / V all-gathered
    (and their gradients reduce-scattered) when a shard's query heads
    need KV heads beyond its block, or copied in when ``wk`` is whole;
    per MLP block a copy-in and an all-reduce; the vocab-split
    embedding's all-reduce, the logits' copy-in, and the loss's max and
    two all-reduces of (b, s) f32 rows."""
    calls = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
             "all_max": 0}
    nbytes = dict.fromkeys(calls, 0)
    act = m * b * s * cfg.d_model * elt
    kv = b * s * cfg.n_kv_heads * cfg.resolved_head_dim * elt

    def add(op, n):
        calls[op] += 1
        nbytes[op] += n

    wk_split = (cfg.n_kv_heads * cfg.resolved_head_dim) % m == 0
    for _ in range(cfg.n_periods):
        for spec in cfg.period:
            assert spec.mixer in ("attn", "attn_local") and spec.ffn == "mlp"
            add("all_reduce", act)
            add("all_reduce", act)
            if wk_split and cfg.n_kv_heads % m:
                for _ in "kv":
                    add("all_gather", kv)
                    add("reduce_scatter", m * kv)
            elif not wk_split:
                for _ in "kv":
                    add("all_reduce", m * kv)
            add("all_reduce", act)
            add("all_reduce", act)
    for _ in range(2):
        add("all_reduce", act)
    add("all_max", m * b * s * 4)
    for _ in range(2):
        add("all_reduce", m * b * s * 4)
    return calls, nbytes


@pytest.mark.parametrize("variant,m", [("smoke", 2), ("smoke", 4),
                                       ("kv1_hd33", 2)])
def test_model_axis_counters_equal_the_layer_list(variant, m):
    cfg = _variant(variant)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    axis = StackModelAxis(m, "cpu")
    _tp_loss_and_grads(params, cfg, m, tokens, tokens, axis)
    calls, nbytes = _derived_counts(cfg, m, 2, 24, 4)
    assert axis.calls == calls and axis.bytes == nbytes
    formula = tp_collectives(cfg, m, 2, 24, torch.float32)
    assert {op: v["calls"] for op, v in formula.items()} == calls
    assert {op: v["bytes"] for op, v in formula.items()} == nbytes
    assert calls["all_reduce"] > 0


def test_remat_recomputes_the_forward_collectives():
    cfg = dataclasses.replace(_variant("smoke"), remat=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros(2, 24, dtype=torch.long)
    axis = StackModelAxis(2, "cpu")
    _, loss, grads = _tp_loss_and_grads(params, cfg, 2, tokens, tokens, axis)
    formula = tp_collectives(cfg, 2, 2, 24, torch.float32)
    assert axis.calls == {op: v["calls"] for op, v in formula.items()}
    calls, _ = _derived_counts(dataclasses.replace(cfg, remat=False), 2, 2,
                               24, 4)
    # each period's output all-reduces run again in the backward
    assert axis.calls["all_reduce"] == calls["all_reduce"] + 2 * len(
        cfg.period) * cfg.n_periods
    axis0 = StackModelAxis(2, "cpu")
    _, loss0, grads0 = _tp_loss_and_grads(
        params, dataclasses.replace(cfg, remat=False), 2, tokens, tokens,
        axis0)
    assert torch.equal(loss.detach(), loss0.detach())
    for a, b in zip(tree_mod.leaves(grads), tree_mod.leaves(grads0)):
        assert torch.equal(a, b)


# configs whose whole split weights have shapes no shard, activation or
# gradient of the run has (96 wide, 4 heads of 20, d_ff 224; 1 KV head at
# M = 2, 2 at M = 4, so that no shard of wq is as wide as a whole wk)
WIDTH_CFG = dict(d_model=96, n_heads=4, head_dim=20, d_ff=224,
                 vocab_size=500)
MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "addbmm", "dot")


def _matmul_operands(fn):
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in MATMULS:
                seen.extend(tuple(a.shape[-2:]) for a in args
                            if isinstance(a, torch.Tensor) and a.dim() >= 2)
            return func(*args, **(kwargs or {}))

    with Spy():
        fn()
    return seen


@pytest.mark.parametrize("m", [2, 4])
def test_no_matmul_takes_a_whole_split_weight(m):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **WIDTH_CFG,
                              n_kv_heads={2: 1, 4: 2}[m])
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(0))
    dims = steps.param_shard_dims(cfg, m)
    whole = set()
    shard = set()
    for key, s in transformer.flat_specs(cfg):
        if dims[key] is None or len(s.shape) < 2:
            continue
        w = s.shape[-2:]
        whole |= {w, w[::-1]}
        k = dims[key] - (len(s.shape) - 2)
        part = list(w)
        part[k] //= m
        shard |= {tuple(part), tuple(part[::-1])}
    assert not whole & shard
    axis = StackModelAxis(m, "cpu")
    seen = _matmul_operands(lambda: _tp_loss_and_grads(
        params, cfg, m, tokens, tokens, axis))
    assert not whole & set(seen), sorted(whole & set(seen))
    assert shard & set(seen)        # the shards' own products were seen

    # the control: the unsharded forward does multiply whole weights
    def plain():
        leaves, struct = tree_mod.flatten(params)
        mine = [v.clone().requires_grad_(True) for v in leaves]
        logits, aux = transformer.forward(tree_mod.unflatten(struct, mine),
                                          cfg, tokens)
        torch.autograd.grad(transformer.lm_loss(logits, tokens,
                                                cfg.vocab_size, aux), mine)

    assert whole & set(_matmul_operands(plain))


def test_tensor_parallelism_refuses_other_families_and_shapes():
    tok = torch.zeros(1, 4, dtype=torch.long)
    # every family runs over the model axis, heads that M does not divide
    # split inside a head (the smoke configs' 4 heads at M = 8; values
    # against JAX in test_torch_tp_head_split.py); what remains refused
    # is ragged offsets and rule overrides
    for arch in ("rwkv6-3b", "whisper-large-v3", ARCH):
        cfg = configs.get_smoke_config(arch)
        ctx = transformer.stub_context(cfg, 1, torch.float32, "cpu")
        params = shard_params(transformer.init_params(cfg, device="cpu"),
                              cfg, 8)
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, tok, context=ctx,
                model_axis=StackModelAxis(8, "cpu"))
        assert logits.shape == (8, 1, 4, cfg.padded_vocab // 8)
        assert torch.isfinite(logits).all()
    # ragged offsets under a model axis: whisper's decode over 2 shards
    from repro_torch.convert import shard_cache
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.train import steps as steps_mod

    cfg = configs.get_smoke_config("whisper-large-v3")
    _, rules = steps_mod.make_decode_fn(cfg, parse_mesh("1x2"), device="cpu")
    cache = shard_cache(transformer.init_cache(cfg, 2, 8, torch.float32,
                                               "cpu"), cfg, rules)
    zeros = torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ragged"):
        transformer.decode_step(
            shard_params(transformer.init_params(cfg, device="cpu"), cfg, 2),
            cfg, zeros, cache, offsets=zeros,
            model_axis=StackModelAxis(2, "cpu"))
    with pytest.raises(ValueError, match="ROADMAP.*5d"):
        steps_mod.make_decode_fn(cfg, parse_mesh("1x8"), device="cpu",
                                 rule_overrides={"seq": "model"})
    if not torch.cuda.is_available():       # entry points target the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StackModelAxis(2)


# ---------------------------------------------------------------------------
# Three train steps on 2x2 against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    pytest.importorskip("jax")
    out = {}
    for mesh_name, cases in MESHES.items():
        for case in cases:
            path = tmp_path_factory.mktemp("jax_tp") / f"{case}.npz"
            proc = subprocess.run(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--jax", case, mesh_name, str(path)],
                capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
                env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                     "HOME": os.environ.get("HOME", "/tmp"),
                     "JAX_PLATFORMS": "cpu"})
            assert proc.returncode == 0, proc.stderr[-3000:]
            with np.load(path) as data:
                out[mesh_name, case] = {k: data[k] for k in data.files}
    return out


def _tc(case):
    method, kw = CASES[case]
    return steps.DistributedTrainConfig(
        model=configs.get_smoke_config(ARCH),
        sdm=sdm_dsgd.SDMConfig(**kw), topology="ring", method=method,
        param_dtype=torch.float32)


def _port_run(case, want, model):
    tc = _tc(case)
    init = {k[len("init/"):]: v for k, v in want.items()
            if k.startswith("init/")}
    params = params_from_jax(init, tc.model, device="cpu")
    transport = tr.StackTransport(NODES, "cpu")
    sent = []
    start = transport.ppermute_start

    def spy(x, perm, **kw):
        sent.append(tuple(x.shape[1:]))
        return start(x, perm, **kw)

    transport.ppermute_start = spy
    axis = StackModelAxis(model, "cpu") if model > 1 else None
    state = steps.init_distributed_state(tc, transport, params=params,
                                         model_axis=axis)
    run = train_mod.train(tc, transport, steps=STEPS, global_batch=BATCH,
                          seq_len=SEQ, state=state, model_axis=axis)
    return tc, params, transport, axis, sent, run


def _check_state(run, want):
    np.testing.assert_allclose(run.losses, want["losses"], rtol=1e-5)
    got = tree_mod.flatten_with_paths(run.state.x)
    wx = {k[2:]: v for k, v in want.items() if k.startswith("x/")}
    assert sorted(got) == sorted(wx)
    for k in wx:
        scale = max(float(np.max(np.abs(wx[k]))), 1.0)
        np.testing.assert_allclose(got[k].numpy(), wx[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    ws = [want[f"s/{i}"] for i in range(len(run.state.s))]
    assert f"s/{len(ws)}" not in want
    for plane, w in zip(run.state.s, ws):
        np.testing.assert_allclose(
            plane.numpy(), w, rtol=0,
            atol=1e-5 * max(float(np.max(np.abs(w))), 1.0))


@pytest.mark.parametrize("case", MESHES["2x2"])
def test_tp_train_steps_match_jax_2x2(jax_runs, case):
    want = jax_runs["2x2", case]
    tc, params, transport, axis, sent, run = _port_run(case, want, MODEL)
    _check_state(run, want)
    with steps.bucket_ctx(tc, MODEL):
        spec = plane_mod.ParamPlane.for_tree(params)
    assert spec.n_buckets == 4 == len(run.state.s)

    # the model-axis collectives: every node's gradient, every step
    formula = tp_collectives(tc.model, MODEL, BATCH // NODES, SEQ,
                             torch.float32)
    assert axis.calls == {op: STEPS * NODES * v["calls"]
                          for op, v in formula.items()}
    assert axis.bytes == {op: STEPS * NODES * v["bytes"]
                          for op, v in formula.items()}

    # the wire: one exchange per bucket plane and round, as JAX's step
    meth, mcfg = tc.resolved()
    seq = steps.gossip_schedule(tc, NODES)
    mode = wire_count.mode_of(meth.name, mcfg)
    per_step = wire_count.permutes_per_step(meth.name, mode, seq, 0,
                                            n_buckets=spec.n_buckets)
    jax_payloads = [tuple(int(d) for d in row[:3] if d)
                    for row in want["payloads"]]
    assert len(jax_payloads) == per_step
    assert transport.permutes == STEPS * per_step == len(sent)
    assert per_step == spec.n_buckets * wire_count.expected_permutes(
        meth.name, mode, seq)
    # each payload on one device of the node (one round: bucket i's is
    # the i-th): a bucket plane's lane stays split over the model axis as
    # the split plan says; a packed payload (block-wide rows) is whole
    assert per_step == spec.n_buckets
    plan = steps.state_shardings(tc, mesh_of("2x2"))
    device, factor = [], {}
    for shape, b, p in zip(sent[:per_step], spec.buckets, plan.s):
        split = p[-1] == "model" and shape[-1] == b.lane
        d = shape[:-1] + (shape[-1] // MODEL,) if split else shape
        device.append(d)
        factor[d] = MODEL if split else 1
    assert sorted(device) == sorted(jax_payloads)
    jax_bytes = sum(4 * math.prod(p) * factor[p] for p in jax_payloads)
    with steps.bucket_ctx(tc, MODEL):
        acc = wire_count.expected_bytes_sent(meth, params, mcfg, seq, STEPS)
    if mcfg.mode == "bernoulli" and mcfg.compressor is None:
        # a Bernoulli mask ships the dense plane; its accounting is an
        # expectation
        assert jax_bytes == sum(4 * b.padded_size for b in spec.buckets)
    else:
        assert transport.bytes_sent == acc
    assert all(v == STEPS * jax_bytes for v in transport.bytes_sent.values())


def mesh_of(name):
    from repro_torch.launch.mesh import parse_mesh

    return parse_mesh(name)


def test_buckets_change_the_draws_as_in_jax(jax_runs):
    """``2x2`` against ``2`` (the same nodes, no model axis, one flat
    plane): the port's ``2`` run equals JAX's, and the parameters the
    ``2x2`` run reaches depart from it by what JAX's depart by."""
    flat_want = jax_runs["2", "fixedk_packed"]
    tp_want = jax_runs["2x2", "fixedk_packed"]
    _, _, transport, axis, _, flat = _port_run("fixedk_packed", flat_want, 1)
    assert axis is None and len(flat.state.s) == 1
    _check_state(flat, flat_want)
    _, _, _, _, _, tp = _port_run("fixedk_packed", tp_want, MODEL)
    got_flat = tree_mod.flatten_with_paths(flat.state.x)
    got_tp = tree_mod.flatten_with_paths(tp.state.x)
    moved = 0
    for k in got_flat:
        want = tp_want[f"x/{k}"] - flat_want[f"x/{k}"]
        got = (got_tp[k] - got_flat[k]).numpy()
        scale = max(float(np.max(np.abs(flat_want[f"x/{k}"]))), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale,
                                   err_msg=k)
        moved += int(np.any(np.abs(want) > 1e-4 * scale))
    assert moved > 0                      # the buckets drew other blocks
    assert transport.permutes == STEPS    # one plane, one round a step


def test_launcher_runs_a_model_axis_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "2",
         "--compressor", "fixedk:8"],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh={'data': 2, 'model': 2}" in out.stdout
    assert "4 wire-plane buckets" in out.stdout
    assert "bucket 3: key ('model', 256) lane 256 rows 512" in out.stdout
    steps_seen = re.findall(r"^step +\d+ loss (\S+) .*model-axis "
                            r"all_reduce (\d+)", out.stdout, re.MULTILINE)
    assert len(steps_seen) == 2
    cfg = configs.get_smoke_config(ARCH)
    want = NODES * tp_collectives(cfg, 2, 2, 64, torch.float32)[
        "all_reduce"]["calls"]
    for loss, calls in steps_seen:
        assert math.isfinite(float(loss)) and int(calls) == want > 0
    with pytest.raises(ValueError, match="ROADMAP"):
        train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--mesh", "2x16x16", "--steps", "1"])
