"""The JAX side of the tensor-parallel family tests, and their shared
port-side checks (``tests/test_torch_tp_moe.py``,
``tests/test_torch_tp_mamba.py``, ``tests/test_torch_tp_rwkv.py``,
``tests/test_torch_tp_encoder.py``, ``tests/test_torch_tp_head_split.py``).

Run as a script (``XLA_FLAGS`` must be set before jax imports; 4 faked
CPU devices)::

  python tests/helpers/tp_family_check.py train ARCH SLOTS OUT.npz
  python tests/helpers/tp_family_check.py serve ARCH MESH[,MESH] OUT.npz
  python tests/helpers/tp_family_check.py forward ARCH VARIANTS OUT.npz
  python tests/helpers/tp_family_check.py many - JOBS OUT.npz

``train``: the JAX package's ``make_distributed_train`` on a ``2x2`` mesh
(sdm-dsgd, fixedk:8, sigma 0.1), ``STEPS`` steps of ``TokenStream``
batches; writes the initial parameters (``init/``), the losses, the
final state (``x/``, ``s/``) and the node-axis collective-permutes of
the compiled step (per-device payload shapes). ``SLOTS`` > 0 keeps the
first SLOTS slots of the smoke config's period (one period); it may
instead be a JSON object ``{"slots": n, "model": {overrides}}``, as
``serve``'s meshes may be ``{"meshes": "1x4", "model": {overrides}}``
(``case_config``: the tests' head-count variants). ``serve``:
``make_prefill_fn`` then ``DECODE_STEPS`` of ``make_decode_fn`` on each
mesh, jitted with the shardings of their rules; writes the parameters
(``p/``), each step's logits and the caches after prefill and decode.
``forward``: for each variant (``VARIANTS``: a JSON object of
config overrides by name), the unsharded forward's logits, aux,
``lm_loss`` and gradients on a seeded batch, with the parameters
(``<variant>/p/``, ``/g/``). ``many``: several cases in one process,
``JOBS`` a JSON object {name: [kind, arch, arg]}, each case's arrays
under ``<name>/``. Inputs come from seeded numpy draws that
the port side repeats; ``conv_b`` / ``dt_bias`` (and rwkv's
``decay_bias`` / ``bonus_u``) are redrawn in ``serve`` and ``forward``.
The audio / vlm families get a seeded context of distinct rows
(``context_input``) in all three: raw into the train step, the forward
and prefill, encoded once (JAX's ``encode_context``) into decode.
"""
import dataclasses
import os
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]

NODES, MODEL, STEPS, BATCH, SEQ = 2, 2, 3, 4, 32
SDM = dict(p=0.2, theta=0.5, gamma=1e-2, sigma=0.1, clip_c=1.0,
           compressor="fixedk:8")
SERVE_BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 4, 22, 48, 4
# constant-initialised leaves (zeros at init) redrawn as small normals so
# that their paths do work, as tests/test_torch_moe_recurrent.py does
REDRAW = ("conv_b", "dt_bias", "decay_bias", "bonus_u")
TIMEOUT = 300


def flat(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def cut(cfg, slots: int):
    """``cfg`` with the first ``slots`` slots of its period (one
    period); 0 keeps it whole."""
    if not slots:
        return cfg
    return dataclasses.replace(cfg, period=cfg.period[:slots],
                               n_layers=slots)


def case_config(configs, arch: str, arg, key: str):
    """(a case's smoke config from ``configs``, its other argument):
    ``arg`` is that argument (``train``'s SLOTS, ``serve``'s meshes) or a
    JSON object holding it under ``key`` beside ``"model"``, the config's
    overrides."""
    import json

    over = {}
    if isinstance(arg, str) and arg.startswith("{"):
        spec = json.loads(arg)
        arg, over = spec[key], spec.get("model", {})
    return dataclasses.replace(configs.get_smoke_config(arch), **over), arg


def context_input(cfg, batch: int, seed: int = 5):
    """A seeded (batch, context rows, d_model) f32 context of distinct
    rows for the audio / vlm families (None for a text model): the
    launchers' stub context has equal rows, under which cross-attention's
    probabilities do not matter."""
    if cfg.family not in ("audio", "vlm"):
        return None
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.n_image_tokens
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)


def serve_inputs(vocab: int):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, (SERVE_BATCH, PROMPT)).astype(np.int32)
    dec = rng.integers(0, vocab, (DECODE_STEPS, SERVE_BATCH)).astype(
        np.int32)
    return tokens, dec


def redraw_params(jax, jparams, seed: int = 0):
    """JAX's init tree with ``REDRAW`` leaves as seeded small normals."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if str(path[-1].key) in REDRAW:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1,
                               jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(one, jparams)


def _jax_train(arch: str, slots, out_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.core.sdm_dsgd import SDMConfig
    from repro.data import TokenStream
    from repro.launch.mesh import make_mesh_by_name
    from repro.train import steps

    cfg, slots = case_config(configs, arch, slots, "slots")
    cfg = cut(cfg, int(slots))
    mesh = make_mesh_by_name(f"{NODES}x{MODEL}")
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig(**SDM),
                                      topology="ring", method="sdm-dsgd",
                                      param_dtype=jnp.float32)
    state = steps.init_distributed_state(tc, mesh, jax.random.PRNGKey(0))
    out = {f"init/{k}": v[0] for k, v in flat(state.x).items()}
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=BATCH,
                         seq_len=SEQ, seed=0)
    batches = [tuple(jnp.asarray(a) for a in stream.batch_at(t))
               for t in range(STEPS)]
    ctx = context_input(cfg, BATCH)
    extra = () if ctx is None else (jnp.asarray(ctx),)
    step = jax.jit(steps.make_distributed_train(tc, mesh)).lower(
        state, *batches[0], *extra).compile()
    shapes = []
    for line in step.as_text().splitlines():
        if "ppermute" not in line or not re.search(
                r" collective-permute(-start)?\(", line):
            continue
        m = re.search(r"= *\(?(\w+)\[([\d,]*)\]", line)
        shapes.append([int(d) for d in m.group(2).split(",") if d])
    losses = []
    want = step.input_shardings[0][0]
    for tokens, labels in batches:
        state, loss = step(jax.device_put(state, want), tokens, labels,
                           *extra)
        losses.append(float(loss))
    out["losses"] = np.asarray(losses)
    out["payloads"] = np.asarray([s + [0] * (3 - len(s)) for s in shapes],
                                 dtype=np.int64).reshape(-1, 3)
    out.update({f"x/{k}": v for k, v in flat(state.x).items()})
    out.update({f"s/{i}": np.asarray(v) for i, v in enumerate(state.s)})
    np.savez(out_path, **out)


def _jax_serve(arch: str, meshes: str, out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro import configs
    from repro.launch.mesh import make_mesh_by_name
    from repro.models import transformer
    from repro.sharding import tree_shardings
    from repro.train import steps

    cfg, meshes = case_config(configs, arch, meshes, "meshes")
    params = redraw_params(jax, transformer.init_params(
        jax.random.PRNGKey(1), cfg))
    out = {f"p/{k}": v for k, v in flat(params).items()}
    tokens, dec = serve_inputs(cfg.vocab_size)
    ctx = context_input(cfg, SERVE_BATCH)
    enc = None if ctx is None else transformer.encode_context(
        params, cfg, jnp.asarray(ctx))
    cache_sds = jax.eval_shape(lambda: transformer.init_cache(
        cfg, SERVE_BATCH, MAX_LEN, jnp.float32))
    cache_axes = transformer.cache_logical_axes(cfg)

    def is_axes(v):
        return v == () or (isinstance(v, tuple) and all(
            isinstance(e, (str, type(None))) for e in v))

    def arrays(cache, prefix):
        return {f"{prefix}/{slot}/{f}": np.asarray(t)
                for slot, st in cache.slots.items()
                for f, t in zip(st._fields, st)}

    for mesh_name in meshes.split(","):
        mesh = make_mesh_by_name(mesh_name)
        made = {}
        for kind, make in (("prefill", steps.make_prefill_fn),
                           ("decode", steps.make_decode_fn)):
            fn, rules = make(cfg, mesh)
            psh = tree_shardings(rules, transformer.param_axes(cfg),
                                 transformer.param_shapes(cfg))
            csh = jax.tree.map(
                lambda ax, sds: rules.sharding(ax, sds.shape) if ax != ()
                else NamedSharding(mesh, PartitionSpec()),
                cache_axes, cache_sds, is_leaf=is_axes)
            tok = rules.sharding(("batch", None) if kind == "prefill"
                                 else ("batch",),
                                 (SERVE_BATCH, PROMPT) if kind == "prefill"
                                 else (SERVE_BATCH,))
            shard = (psh, tok, csh)
            if ctx is not None:
                shard += (rules.sharding(("batch", None, "embed"),
                                         ctx.shape),)
            made[kind] = (jax.jit(fn, in_shardings=shard), csh)
        jf, _ = made["prefill"]
        cache = transformer.init_cache(cfg, SERVE_BATCH, MAX_LEN,
                                       jnp.float32)
        pre = () if ctx is None else (jnp.asarray(ctx),)
        post = () if ctx is None else (enc,)
        logits, cache = jf(params, jnp.asarray(tokens), cache, *pre)
        out[f"{mesh_name}/logits/0"] = np.asarray(logits)
        out.update(arrays(cache, f"{mesh_name}/prefill"))
        jd, csh = made["decode"]
        for t in range(DECODE_STEPS):
            # a step's output cache may come back in another layout
            # (rwkv's token-shift states split by embed): re-place it
            cache = jax.device_put(cache, csh)
            logits, cache = jd(params, jnp.asarray(dec[t]), cache, *post)
            out[f"{mesh_name}/logits/{t + 1}"] = np.asarray(logits)
        out.update(arrays(cache, f"{mesh_name}/decode"))
    np.savez(out_path, **out)


def _jax_forward(arch: str, variants: str, out_path: str) -> None:
    import json

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import transformer

    out = {}
    for name, over in json.loads(variants).items():
        cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
        params = redraw_params(jax, transformer.init_params(
            jax.random.PRNGKey(1), cfg))
        tokens, labels = forward_inputs(cfg.vocab_size)
        ctx = context_input(cfg, len(tokens))
        ctx = None if ctx is None else jnp.asarray(ctx)

        def loss_fn(p):
            logits, aux = transformer.forward(p, cfg, jnp.asarray(tokens),
                                              context=ctx)
            return transformer.lm_loss(logits, jnp.asarray(labels),
                                       cfg.vocab_size, aux), (logits, aux)

        (loss, (logits, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        out.update({f"{name}/p/{k}": v for k, v in flat(params).items()})
        out.update({f"{name}/g/{k}": v for k, v in flat(grads).items()})
        out.update({f"{name}/loss": np.asarray(loss),
                    f"{name}/aux": np.asarray(aux),
                    f"{name}/logits": np.asarray(logits)})
    np.savez(out_path, **out)


def _jax_many(jobs: str, out_path: str) -> None:
    import json
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (kind, arch, arg)) in enumerate(
                json.loads(jobs).items()):
            path = os.path.join(tmp, f"{i}.npz")
            CASES[kind](arch, arg, path)
            with np.load(path) as data:
                out.update({f"{name}/{k}": data[k] for k in data.files})
    np.savez(out_path, **out)


CASES = {"train": _jax_train, "serve": _jax_serve, "forward": _jax_forward}


def forward_inputs(vocab: int):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, 24)).astype(np.int32)
    return tokens, labels


def start(kind: str, arch: str, arg: str, out_path):
    """Start one JAX case in a subprocess (``Popen``)."""
    import subprocess

    return subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), kind, arch,
         arg, str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"})


def collect(proc, out_path) -> dict:
    """Wait for a case started by ``start``; its arrays."""
    _, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# The port side
# ---------------------------------------------------------------------------

def close(got, want, rtol: float, what: str, floor: float = 1e-3) -> None:
    """|got - want| <= rtol x max(max |want|, floor), elementwise."""
    scale = max(float(np.max(np.abs(want))), floor)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale, err_msg=what)


class LastShardDropped:
    """A model axis whose all-reduce drops the last shard's partials: the
    seeded fault of a family's *g* (chip_smoke's phases 27d / 28d)."""

    def __init__(self, axis):
        self.axis = axis

    def __getattr__(self, name):
        return getattr(self.axis, name)

    def all_reduce(self, x):
        x = x.clone()
        x[-1] = 0
        return self.axis.all_reduce(x)


def reversed_order(params, cfg):
    """rwkv6's parameters with the heads and the channel mix's d_ff
    reversed: the same function, whose time-mix ``w_out`` and
    channel-mix ``w_v`` products sum in another order (chip_smoke's
    witness of phase 28c)."""
    import torch

    from repro_torch import tree as tree_mod

    h, n = cfg.rwkv_n_heads, cfg.rwkv_head_size
    heads = torch.arange(h * n).view(h, n).flip(0).reshape(-1)
    flat = dict(tree_mod.flatten_with_paths(params))
    for k, v in flat.items():
        name = k.rsplit("/", 1)[-1]
        if "/time_mix/" in k and name in ("w_r", "w_k", "w_v", "w_decay",
                                          "w_g"):
            flat[k] = v[..., heads.to(v.device)].contiguous()
        elif "/time_mix/" in k and name in ("decay_bias", "bonus_u"):
            flat[k] = v.flip(-2).contiguous()
        elif "/time_mix/" in k and name == "w_out":
            flat[k] = v[..., heads.to(v.device), :].contiguous()
        elif "/channel_mix/" in k and name in ("w_k", "w_v"):
            flat[k] = v.flip(-1 if name == "w_k" else -2).contiguous()
    return tree_mod.from_flat(flat)


def tp_loss_and_grads(params, cfg, m: int, tokens, labels, axis,
                      context=None):
    """The port's forward, ``lm_loss`` and gradients over ``m`` shards
    (``convert.shard_params`` of the unsharded ``params``; ``context``:
    the audio / vlm families' raw context): (shards, logits, aux, loss,
    the gradients unsharded)."""
    import torch

    from repro_torch import tree as tree_mod
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.models import transformer

    shards = shard_params(params, cfg, m)
    leaves, struct = tree_mod.flatten(shards)
    mine = [v.requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      tokens, context=context,
                                      model_axis=axis)
    loss = transformer.lm_loss(logits, labels, cfg.vocab_size, aux,
                               model_axis=axis)
    grads = unshard_params(tree_mod.unflatten(
        struct, list(torch.autograd.grad(loss, mine))), cfg, m)
    return shards, logits, aux, loss, grads


def port_train_2x2(arch: str, slots, want: dict):
    """The port's ``2x2`` run from JAX's initial parameters (``slots``:
    as the ``train`` case's argument): (tc, params, transport, axis, the
    payload shapes sent, the run)."""
    import torch

    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.core import sdm_dsgd, transport as tr
    from repro_torch.core.model_axis import StackModelAxis
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import TrainRun
    from repro_torch.train import steps

    cfg, slots = case_config(configs, arch, slots, "slots")
    tc = steps.DistributedTrainConfig(
        model=cut(cfg, int(slots)), sdm=sdm_dsgd.SDMConfig(**SDM),
        topology="ring", method="sdm-dsgd", param_dtype=torch.float32)
    init = {k[len("init/"):]: v for k, v in want.items()
            if k.startswith("init/")}
    params = params_from_jax(init, tc.model, device="cpu")
    transport = tr.StackTransport(NODES, "cpu")
    sent = []
    send = transport.ppermute_start

    def spy(x, perm, **kw):
        sent.append(tuple(x.shape[1:]))
        return send(x, perm, **kw)

    transport.ppermute_start = spy
    axis = StackModelAxis(MODEL, "cpu")
    state = steps.init_distributed_state(tc, transport, params=params,
                                         model_axis=axis)
    # the launcher's step loop (``launch.train.train``), with the seeded
    # context in place of its stub
    step = steps.make_distributed_train(tc, transport, model_axis=axis)
    stream = TokenStream(vocab_size=tc.model.vocab_size, batch=BATCH,
                         seq_len=SEQ, seed=0)
    ctx = context_input(tc.model, BATCH)
    ctx = None if ctx is None else torch.from_numpy(ctx)
    losses = []
    for t in range(STEPS):
        tokens, labels = (torch.as_tensor(a) for a in stream.batch_at(t))
        state, loss = step(state, tokens, labels, ctx)
        losses.append(float(loss))
    run = TrainRun(state=tr.settle(state), losses=losses, step_s=[],
                   tokens_per_step=BATCH * SEQ)
    return tc, params, transport, axis, sent, run


def check_train_2x2(want: dict, tc, params, transport, axis, sent, run,
                    rtol: float) -> None:
    """The port's ``2x2`` run against JAX's: losses (1e-5), the state
    (``rtol`` of each leaf's and plane's scale), the bucket planes, the
    model-axis counters against ``tp_collectives`` every step, and the
    node wire: one permute per bucket plane and round, each payload of
    JAX's per-device shape (a bucket plane's lane split over the model
    axis where the split plan says so)."""
    import torch

    from repro_torch import tree as tree_mod
    from repro_torch.core import plane as plane_mod, wire_count
    from repro_torch.core.model_axis import tp_collectives
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.train import steps

    np.testing.assert_allclose(run.losses, want["losses"], rtol=1e-5)
    got = tree_mod.flatten_with_paths(run.state.x)
    wx = {k[2:]: v for k, v in want.items() if k.startswith("x/")}
    assert sorted(got) == sorted(wx)
    for k in wx:
        close(got[k].numpy(), wx[k], rtol, k, floor=1.0)
    ws = [want[f"s/{i}"] for i in range(len(run.state.s))]
    assert f"s/{len(ws)}" not in want
    for i, (plane, w) in enumerate(zip(run.state.s, ws)):
        close(plane.numpy(), w, rtol, f"plane {i}", floor=1.0)

    with steps.bucket_ctx(tc, MODEL):
        spec = plane_mod.ParamPlane.for_tree(params)
    assert spec.n_buckets == len(run.state.s) > 1
    formula = tp_collectives(tc.model, MODEL, BATCH // NODES, SEQ,
                             torch.float32)
    assert axis.calls == {op: STEPS * NODES * v["calls"]
                          for op, v in formula.items()}
    assert axis.bytes == {op: STEPS * NODES * v["bytes"]
                          for op, v in formula.items()}

    meth, mcfg = tc.resolved()
    seq = steps.gossip_schedule(tc, NODES)
    mode = wire_count.mode_of(meth.name, mcfg)
    per_step = wire_count.permutes_per_step(meth.name, mode, seq, 0,
                                            n_buckets=spec.n_buckets)
    jax_payloads = [tuple(int(d) for d in row if d)
                    for row in want["payloads"]]
    assert len(jax_payloads) == per_step == spec.n_buckets
    assert transport.permutes == STEPS * per_step == len(sent)
    plan = steps.state_shardings(tc, parse_mesh(f"{NODES}x{MODEL}"))
    device = []
    for shape, b, p in zip(sent[:per_step], spec.buckets, plan.s):
        split = p[-1] == "model" and shape[-1] == b.lane
        device.append(shape[:-1] + (shape[-1] // MODEL,) if split
                      else shape)
    assert sorted(device) == sorted(jax_payloads)
    with steps.bucket_ctx(tc, MODEL):
        acc = wire_count.expected_bytes_sent(meth, params, mcfg, seq, STEPS)
    assert transport.bytes_sent == acc


def check_serving_1xm(arch: str, mesh_name: str, want: dict, rtol: float,
                      cfg=None, params=None, prefix=None) -> None:
    """``make_prefill_fn`` / ``make_decode_fn`` on ``mesh_name`` against
    ``want`` (JAX's arrays under ``prefix``, by default the mesh's name):
    logits and the unsharded cache (KV, mamba and rwkv states) within
    ``rtol`` of their scale, the counters against
    ``tp_serving_collectives`` every step, the mamba states split by
    channel and the rwkv WKV states by heads. The audio / vlm families
    prefill on ``context_input``'s raw context and decode on it encoded
    over the same model axis (``transformer.encode_context``)."""
    import torch

    from repro_torch import configs
    from repro_torch.convert import (params_from_jax, shard_cache,
                                     shard_params, unshard_cache)
    from repro_torch.core.model_axis import (StackModelAxis,
                                             tp_serving_collectives)
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import mamba, rwkv, transformer
    from repro_torch.train import steps

    prefix = prefix or mesh_name
    cfg = cfg or configs.get_smoke_config(arch)
    if params is None:
        params = params_from_jax({k[2:]: v for k, v in want.items()
                                  if k.startswith("p/")}, cfg, device="cpu")
    mesh = parse_mesh(mesh_name)
    m = mesh.model
    tokens, dec = serve_inputs(cfg.vocab_size)
    ctx = context_input(cfg, SERVE_BATCH)
    ctx = None if ctx is None else torch.from_numpy(ctx)
    pf, prules = steps.make_prefill_fn(cfg, mesh, device="cpu")
    df, drules = steps.make_decode_fn(cfg, mesh, device="cpu")
    sp = shard_params(params, cfg, m)
    cache = shard_cache(transformer.init_cache(
        cfg, SERVE_BATCH, MAX_LEN, torch.float32, "cpu"), cfg, prules)

    def counts(axis):
        return {op: {"calls": axis.calls[op], "bytes": axis.bytes[op]}
                for op in axis.calls}

    def check_cache(cache, rules, what):
        whole = unshard_cache(cache, cfg, rules)
        for slot, st in whole.slots.items():
            for f, t in zip(st._fields, st):
                close(t.numpy(), want[f"{prefix}/{what}/{slot}/{f}"], rtol,
                      f"{what} cache {slot}/{f}")
        for slot, st in cache.slots.items():
            if isinstance(st, mamba.MambaState):   # split by channel
                assert st.conv.shape[1:] == (m, SERVE_BATCH,
                                             cfg.mamba_d_conv - 1,
                                             cfg.mamba_d_inner // m)
                assert st.ssm.shape[1:] == (m, SERVE_BATCH,
                                            cfg.mamba_d_inner // m,
                                            cfg.mamba_d_state)
            if isinstance(st, rwkv.RWKVState):     # WKV split by heads
                n, h = cfg.rwkv_head_size, cfg.rwkv_n_heads
                assert st.wkv.shape[1:] == (m, SERVE_BATCH) + (
                    (h // m, n, n) if h % m == 0   # or by columns
                    else (h * n // m, n))
                assert st.att_shift.shape[1:] == (SERVE_BATCH, cfg.d_model)

    logits, cache = pf(sp, torch.from_numpy(tokens), cache, ctx)
    enc = None if ctx is None else transformer.encode_context(
        sp, cfg, ctx, model_axis=StackModelAxis(m, "cpu"))
    assert logits.shape == (m, SERVE_BATCH, cfg.padded_vocab // m)
    close(torch.cat(list(logits), -1).numpy(), want[f"{prefix}/logits/0"],
          rtol, "prefill logits")
    check_cache(cache, prules, "prefill")
    formula = tp_serving_collectives(cfg, m, SERVE_BATCH, PROMPT, "prefill",
                                     torch.float32)
    assert counts(pf.model_axis) == formula
    cache = shard_cache(unshard_cache(cache, cfg, prules), cfg, drules)
    per_step = tp_serving_collectives(cfg, m, SERVE_BATCH, 1, "decode",
                                      torch.float32)
    for t in range(DECODE_STEPS):
        df.model_axis.reset_counters()
        logits, cache = df(sp, torch.from_numpy(dec[t]), cache, enc)
        close(torch.cat(list(logits), -1).numpy(),
              want[f"{prefix}/logits/{t + 1}"], rtol,
              f"decode step {t} logits")
        assert counts(df.model_axis) == per_step
    assert cache.offset == PROMPT + DECODE_STEPS
    check_cache(cache, drules, "decode")


def check_dryrun_nxm(arch: str, mesh_name: str, shape: str,
                     seq_len: int) -> dict:
    """``launch.dryrun.build_case`` of a smoke config on an ``NxM`` mesh
    (one device over a ``ShardModelAxis`` on ``meta``; train and prefill
    at ``seq_len`` tokens, train without noise: the per-leaf draws
    dominate a trace): its model-axis collectives under JAX's HLO
    names equal ``tp_collectives`` / ``tp_serving_collectives`` (one
    device's calls, its bytes 1/M of the stack's) beside the node wire's
    permutes (one a bucket plane and round), and a train case launches
    the gather-pack once a bucket plane. Returns the record."""
    import torch

    from repro_torch import configs
    from repro_torch.core import gossip, method as method_mod, sdm_dsgd
    from repro_torch.core import wire_count
    from repro_torch.core.model_axis import (tp_collectives,
                                             tp_serving_collectives)
    from repro_torch.core.plane import ParamPlane
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import transformer
    from repro_torch.train import steps

    mesh = parse_mesh(mesh_name)
    n, m = mesh.n_nodes, mesh.model
    case = shapes.SHAPES[shape]
    over = {"seq_len": seq_len} if case.kind != "decode" else {}
    case = dataclasses.replace(case, **over)
    rec = dryrun.build_case(arch, shape, mesh_name, "sdm-dsgd",
                            "fixedk_packed", "", verbose=False, smoke=True,
                            shape_overrides=over,
                            sdm_overrides={"sigma": 0.0})
    assert rec["status"] == "ok" and rec["n_devices"] == n * m
    cfg = configs.get_smoke_config(arch)
    rows = case.global_batch // n if case.kind == "train" \
        else -(-case.global_batch // n)
    ops = {}
    if case.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
        tp = tp_collectives(cfg, m, rows, case.seq_len, torch.bfloat16)
        meth = method_mod.get("sdm-dsgd")
        mcfg = meth.coerce_config(sdm_dsgd.SDMConfig(
            mode="fixedk_packed", pack_block=1024))
        seq = gossip.sequence_by_name("ring", n, self_weight=1 / 3,
                                      placement=True)
        tc = steps.DistributedTrainConfig(model=cfg, sdm=mcfg)
        with steps.bucket_ctx(tc, m):
            buckets = ParamPlane.for_tree(transformer.unflatten({
                k: torch.empty(s, device="meta") for k, s in
                transformer.param_shapes(cfg).items()})).n_buckets
        perms = wire_count.permutes_per_step(
            meth.name, wire_count.mode_of(meth.name, mcfg), seq, 0,
            n_buckets=buckets)
        if perms:
            ops["collective-permute"] = perms
        assert rec["kernel_calls"] == {"fixedk_gather_pack": buckets}
    else:
        tp = tp_serving_collectives(cfg, m, rows, case.seq_len
                                    if case.kind == "prefill" else 1,
                                    case.kind, torch.bfloat16)
    for op, name in dryrun.HLO_NAMES.items():
        if tp[op]["calls"]:
            ops[name] = ops.get(name, 0) + tp[op]["calls"]
    assert rec["collective_ops"] == ops, (rec["collective_ops"], ops)
    model_bytes = sum(v for k, v in rec["collective_bytes"].items()
                      if k not in ("total", "collective-permute"))
    assert model_bytes * m == sum(v["bytes"] for v in tp.values())
    return rec


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, str(ROOT / "src"))
    kind, arch, arg, out = sys.argv[1:5]
    if kind == "many":
        _jax_many(arg, out)
    elif kind in CASES:
        CASES[kind](arch, arg, out)
    else:
        raise SystemExit(f"unknown case {kind!r}")
