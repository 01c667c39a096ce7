"""PyTorch port: ``launch/shapes``, the meta-device dry-run and the
roofline, against the JAX package on the CPU.

- Shapes: ``SHAPES``, ``LONG_OK`` and ``skip_reason`` over the 10 arches
  x 4 shapes (33 runnable, 7 skipped) equal JAX's; every leaf shape and
  dtype of ``input_specs`` for each runnable case equals JAX's, the
  cache against ``jax.eval_shape(init_cache)``. The cache layout is the
  same, slot for slot; the one mapping: JAX's ``offset`` is a () int32
  array, the port's a Python int (0).
- Dry-run at smoke size on mesh 4, one case of each kind (train, prefill,
  decode, long_500k: gemma2-2b, named as the full config so that
  long_500k runs in both packages) and JAX's skip case (phi3-medium-14b,
  long_500k): ``status`` and the key set equal the JAX ``build_case``
  record's (run in a subprocess: its module fakes 512 devices before jax
  starts), the port's ``trace_s`` in place of ``lower_s`` / ``compile_s``;
  ``collective_ops`` = ``wire_count``'s permutes (= JAX's
  collective-permutes); ``collective_bytes["total"]`` = the transport's
  ``bytes_sent`` per node; the matmul flops within 2 % of an analytic
  count from the config (exact here).
- The probes: rwkv6's quadratic extrapolation over the sequence (flops,
  bytes, wire; the memory peak, extrapolated linearly, within 2 %), and
  the train step's node symmetry, each against a full count at smoke
  size.
- Each kernel wrapper's meta branch adds exactly its ``kernels/cost.py``
  count and launches nothing; a CPU tensor still takes the plain
  version, an unknown device still raises, ``resolve_device("meta")``
  raises without the opt-in.
- ``bench/roofline.analyze_record`` of a JAX-shaped record returns JAX's
  keys, with the H100 constants in its terms.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.bench import roofline  # noqa: E402
from repro_torch.core import wire_count  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHES = sorted(configs.ALIASES)
CASES = [(a, s) for a in ARCHES for s in shapes.SHAPES]


# ---------------------------------------------------------------------------
# launch/shapes
# ---------------------------------------------------------------------------

def test_shapes_and_skips_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}
    assert shapes.LONG_OK == jax_shapes.LONG_OK
    assert len(ARCHES) == 10
    skipped = 0
    for arch, name in CASES:
        got = shapes.skip_reason(configs.get_config(arch), shapes.SHAPES[name])
        want = jax_shapes.skip_reason(jax_configs.get_config(arch),
                                      jax_shapes.SHAPES[name])
        assert got == want, (arch, name)
        skipped += got is not None
    assert (len(CASES) - skipped, skipped) == (33, 7)


_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
       jnp.float32: torch.float32}


def _jax_leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(v.shape),
                                      _DT[jnp.dtype(v.dtype).type])
            for p, v in leaves}


def _port_specs(specs):
    """The port's specs keyed as JAX's key paths (the cache's offset, a
    Python int here and a () int32 array in JAX, left out of both)."""
    out = {}
    for name, v in specs.items():
        if name != "cache":
            out[f"['{name}']"] = (tuple(v.shape), v.dtype)
            continue
        for slot, st in v.slots.items():
            for field, t in zip(st._fields, st):
                out[f"['cache'].slots['{slot}'].{field}"] = (tuple(t.shape),
                                                             t.dtype)
    return out


@pytest.mark.parametrize("arch", ARCHES)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    for name, case in shapes.SHAPES.items():
        if shapes.skip_reason(cfg, case):
            continue
        specs = shapes.input_specs(cfg, case)
        assert all(t.device.type == "meta" for k, t in specs.items()
                   if k != "cache")
        want = _jax_leaves(jax_shapes.input_specs(jcfg,
                                                  jax_shapes.SHAPES[name]))
        assert want.pop("['cache'].offset", None) in (None, ((), torch.int32))
        assert _port_specs(specs) == want, (arch, name)
        if "cache" in specs:
            assert specs["cache"].offset == 0


# ---------------------------------------------------------------------------
# The dry-run against JAX's records
# ---------------------------------------------------------------------------

_JAX_CASES = """
import json, sys
from repro.launch import dryrun
out = {}
for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
    out[shape] = dryrun.build_case(
        "gemma2-2b", shape, "4", "sdm-dsgd", "fixedk_packed", "",
        verbose=False, probes=False, smoke=True,
        cfg_overrides={"name": "gemma2-2b"})
out["skip"] = dryrun.build_case("phi3-medium-14b", "long_500k", "4",
                                "sdm-dsgd", "fixedk_packed", "",
                                verbose=False, probes=False)
for mesh in TP_MESHES:
    for shape in TP_SHAPES:
        out[mesh + "/" + shape] = dryrun.build_case(
            "gemma2-2b", shape, mesh, "sdm-dsgd", "fixedk_packed", "",
            verbose=False, probes=False, smoke=True,
            cfg_overrides={"name": "gemma2-2b"})
print(json.dumps(out, default=str))
"""
# the NxM meshes and cases held to JAX's records (4 faked devices each)
TP_MESHES = ("1x4", "2x2")
TP_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def jax_records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    code = f"TP_MESHES, TP_SHAPES = {TP_MESHES!r}, {TP_SHAPES!r}\n" \
        + _JAX_CASES
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    recs = {shape: dryrun.build_case(
        "gemma2-2b", shape, "4", "sdm-dsgd", "fixedk_packed", str(out),
        verbose=False, smoke=True, cfg_overrides={"name": "gemma2-2b"})
        for shape in shapes.SHAPES}
    recs["skip"] = dryrun.build_case("phi3-medium-14b", "long_500k", "4",
                                     "sdm-dsgd", "fixedk_packed", str(out),
                                     verbose=False)
    for mesh in TP_MESHES:
        for shape in TP_SHAPES:
            recs[mesh + "/" + shape] = dryrun.build_case(
                "gemma2-2b", shape, mesh, "sdm-dsgd", "fixedk_packed",
                str(out), verbose=False, smoke=True,
                cfg_overrides={"name": "gemma2-2b"})
    return recs, out


def _analytic_flops(cfg, kind: str, b: int, s: int) -> int:
    """Matmul flops from the config: 2 per weight a token (q, k, v, o,
    the GLU's three), the full (sq, skv) score and value products of the
    written-out attention (4 h dh a pair), the tied head (2 d V_pad a
    scored token). Train: the layers run forward twice (remat) and
    backward (2 x forward); the head forward and backward."""
    w = sum(int(np.prod(sh)) for k, sh in transformer.param_shapes(cfg).items()
            if k.startswith("blocks/") and len(sh) == 3)
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    sq, skv = (1, s) if kind == "decode" else (s, s)
    layers = 2 * w * b * sq + cfg.n_layers * 4 * h * dh * sq * skv * b
    scored = b * s if kind == "train" else b
    head = 2 * cfg.d_model * cfg.padded_vocab * scored
    return 4 * layers + 3 * head if kind == "train" else layers + head


def test_dryrun_records_match_jax_keys_and_counts(jax_records, port_records):
    recs, out = port_records
    cfg = dataclasses.replace(configs.get_smoke_config("gemma2-2b"),
                              name="gemma2-2b")
    for shape, want in jax_records.items():
        if "/" in shape:
            continue                       # the NxM records: below
        got = recs[shape]
        assert got["status"] == want["status"], shape
        assert set(got) - {"trace_s", "kernel_calls"} == \
            set(want) - {"lower_s", "compile_s"}, shape
    assert recs["skip"] == {k: v for k, v in jax_records["skip"].items()}
    assert recs["skip"]["status"] == "skipped"

    n = 4
    for shape in shapes.SHAPES:
        rec, case = recs[shape], shapes.SHAPES[shape]
        for k in ("n_devices", "n_nodes", "n_periods", "per_node_batch",
                  "tokens_per_step", "algorithm", "model_params",
                  "model_params_active"):
            assert rec[k] == jax_records[shape][k], (shape, k)
        rows = case.global_batch // n if case.kind == "train" else \
            -(-case.global_batch // n)
        want = _analytic_flops(cfg, case.kind, rows, case.seq_len)
        assert abs(rec["flops"] - want) <= 0.02 * want, (shape, rec["flops"],
                                                         want)
        assert set(rec["memory"]) >= {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "peak_memory_in_bytes"}
        assert rec["memory"]["peak_memory_in_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"] > 0
        assert (out / "4" / "gemma2-2b" / f"{shape}.json").exists()

    # the wire: ring, fixedk_packed, 2 permutes a step (JAX's HLO too)
    train = recs["train_4k"]
    from repro_torch.core import method as method_mod, sdm_dsgd, gossip
    meth = method_mod.get("sdm-dsgd")
    mcfg = meth.coerce_config(sdm_dsgd.SDMConfig(mode="fixedk_packed",
                                                 pack_block=1024))
    seq = gossip.sequence_by_name("ring", n, self_weight=1.0 / 3.0)
    perms = wire_count.expected_permutes(
        meth.name, wire_count.mode_of(meth.name, mcfg), seq)
    assert train["collective_ops"] == {"collective-permute": perms} == \
        {"collective-permute": jax_records["train_4k"]["collective_ops"][
            "collective-permute"]}
    assert train["kernel_calls"] == {"fixedk_gather_pack": 1}
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        assert recs[shape]["collective_ops"] == {}
        assert recs[shape]["collective_bytes"] == {"total": 0}


def test_dryrun_nxm_records_match_jax(jax_records, port_records):
    """``1x4`` and ``2x2``: one device's record (one shard of one node,
    traced over a ``ShardModelAxis``) against JAX's ``build_case`` on 4
    faked devices: status, keys and ``n_devices``; the prefill and
    decode cases' per-device arguments byte for byte; the matmul flops
    within 2 % of the analytic count over M (every weight of the smoke
    config splits; attention: own heads, or all heads over 1/M of the
    positions); the collectives: the model axis's under JAX's names
    (``tp_serving_collectives`` / ``tp_collectives``, one device's calls)
    and the node wire (``permutes_per_step``, one per bucket plane)."""
    from repro_torch.core import gossip, method as method_mod, sdm_dsgd
    from repro_torch.core.model_axis import (tp_collectives,
                                             tp_serving_collectives)
    from repro_torch.core.plane import ParamPlane
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.train import steps

    recs, out = port_records
    cfg = dataclasses.replace(configs.get_smoke_config("gemma2-2b"),
                              name="gemma2-2b")
    for mesh_name in TP_MESHES:
        mesh = parse_mesh(mesh_name)
        n, m = mesh.n_nodes, mesh.model
        for shape in TP_SHAPES:
            key = mesh_name + "/" + shape
            got, want = recs[key], jax_records[key]
            case = shapes.SHAPES[shape]
            assert got["status"] == want["status"] == "ok", key
            assert set(got) - {"trace_s", "kernel_calls"} == \
                set(want) - {"lower_s", "compile_s"}, key
            for k in ("n_devices", "n_nodes", "per_node_batch",
                      "tokens_per_step", "algorithm"):
                assert got[k] == want[k], (key, k)
            assert got["n_devices"] == n * m == 4
            rows = case.global_batch // n
            analytic = _analytic_flops(cfg, case.kind, rows,
                                       case.seq_len) / m
            assert abs(got["flops"] - analytic) <= 0.02 * analytic, \
                (key, got["flops"], analytic)
            assert (out / mesh_name / "gemma2-2b" / f"{shape}.json").exists()
            if case.kind == "train":
                tp = tp_collectives(dataclasses.replace(cfg, remat=True), m,
                                    rows, case.seq_len, torch.bfloat16)
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
                want_ops = {"collective-permute": perms} if perms else {}
                assert buckets == 4
            else:
                want_ops = {}
                tp = tp_serving_collectives(cfg, m, rows, case.seq_len
                                            if case.kind == "prefill" else 1,
                                            case.kind, torch.bfloat16)
                assert got["memory"]["argument_size_in_bytes"] == \
                    want["memory"]["argument_size_in_bytes"], key
            for op, name in dryrun.HLO_NAMES.items():
                if tp[op]["calls"]:
                    want_ops[name] = want_ops.get(name, 0) + tp[op]["calls"]
            assert got["collective_ops"] == want_ops, key
            stack_bytes = sum(v["bytes"] for v in tp.values())
            model_bytes = sum(v for k, v in got["collective_bytes"].items()
                              if k not in ("total", "collective-permute"))
            assert model_bytes * m == stack_bytes, key


def test_pod_meshes_parse_in_the_dryrun_alone():
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import parse_mesh

    assert parse_mesh("16x16", pods=True).shape == {"data": 16, "model": 16}
    assert parse_mesh("multi_pod", pods=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    rec = dryrun.build_case("gemma2-2b", "decode_32k", "16x16", "sdm-dsgd",
                            "fixedk_packed", "", verbose=False, smoke=True,
                            cfg_overrides={"n_heads": 16, "n_kv_heads": 16})
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["collective_ops"]["all-gather"] > 0
    with pytest.raises(ValueError, match="pod mesh"):
        train_mod.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                        "--mesh", "16x16", "--steps", "1"])
    with pytest.raises(ValueError, match="pod mesh"):
        parse_mesh("2x16x16")


def test_collective_bytes_are_the_transports(monkeypatch):
    """``collective_bytes["total"]`` is the transport's ``bytes_sent``
    over the nodes, per node (every ring node sends the same)."""
    from repro_torch.core import transport as tr

    made = []
    real = tr.StackTransport

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(tr, "StackTransport", spy)
    case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=16,
                               global_batch=4)
    got = dryrun._measure(configs.get_smoke_config("gemma2-2b"), case, 4,
                          "sdm-dsgd", "fixedk_packed", None, "ring", None,
                          True)
    (t,) = made
    sent = t.bytes_sent
    assert len(set(sent.values())) == 1 and sent[0] > 0
    assert got["collective_bytes"] == {"collective-permute": sent[0],
                                       "total": sent[0]}
    assert got["collective_ops"] == {"collective-permute": t.permutes}


# ---------------------------------------------------------------------------
# The probes
# ---------------------------------------------------------------------------

def _same(a, b, key):
    if isinstance(a[key], dict):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            assert b[key][k] == pytest.approx(a[key][k], rel=1e-12), (key, k)
    else:
        assert b[key] == pytest.approx(a[key], rel=1e-12), key


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k"])
def test_rwkv_sequence_probes_equal_a_full_count(kind, monkeypatch):
    monkeypatch.setattr(dryrun, "SEQ_PROBE", 4)
    cfg = configs.get_smoke_config("rwkv6-3b")
    case = dataclasses.replace(shapes.SHAPES[kind], seq_len=28,
                               global_batch=4)
    a = (2, "sdm-dsgd", "fixedk_packed", None, "ring", None, True)
    full = dryrun._measure(cfg, case, *a)
    probed = dryrun._measure_probed(cfg, case, *a)
    assert probed["seq_probes"]["seq_len"] == [4, 8, 12]
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        _same(full, probed, key)
    assert probed["collective_ops"] == full["collective_ops"]
    # the memory peak goes by the line through the last two probes
    for k, v in full["memory"].items():
        assert probed["memory"][k] == pytest.approx(v, rel=0.02), k


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3"])
def test_node_symmetry_equals_every_node_traced(arch):
    cfg = configs.get_smoke_config(arch)
    case = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=8,
                               global_batch=8)
    a = (4, "sdm-dsgd", "fixedk_packed", None, "ring", None)
    each = dryrun._measure(cfg, case, *a, False)
    sym = dryrun._measure(cfg, case, *a, True)
    for key in ("flops", "bytes_accessed", "collective_bytes", "memory",
                "collective_ops", "kernel_calls"):
        assert sym[key] == each[key], key


def test_dryrun_cli_runs_a_case_and_the_roofline_reads_it(tmp_path, capsys):
    out = tmp_path / "dr"
    assert dryrun.main(["--smoke", "--arch", "gemma2-2b", "--shape",
                        "decode_32k,long_500k", "--mesh", "4", "--out",
                        str(out)]) == 0
    assert "dry-run complete" in capsys.readouterr().out
    rows = roofline.run(str(out))
    assert [r["shape"] for r in rows] == ["decode_32k"]   # long_500k skips
    assert "roofline/gemma2-2b/decode_32k/4," in capsys.readouterr().out
    with pytest.raises(ValueError, match="tensor-parallel"):
        dryrun.build_case("gemma2-2b", "train_4k", "4", "sdm-dsgd",
                          "fixedk_packed", "", smoke=True,
                          rule_overrides={"mlp": ("model",)})
    with pytest.raises(ValueError, match="5d"):
        dryrun.build_case("gemma2-2b", "prefill_32k", "1x2", "sdm-dsgd",
                          "fixedk_packed", "", smoke=True,
                          rule_overrides={"kv_heads": None})


# ---------------------------------------------------------------------------
# Kernel wrappers on meta, the CPU and elsewhere
# ---------------------------------------------------------------------------

class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the port does not take."""

    @property
    def device(self):
        return torch.device("xpu")


def _kernel_calls():
    """(name, wrapper, args builder(device), kwargs, the kernel's Cost)."""
    from repro_torch.kernels.flash_attn.decode import paged_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.sdm_update.ops import sdm_update_planes
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   qsgd_pack)

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def decode_args():
        tbl = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        return (rnd(2, 8, 32), rnd(9, 4, 2, 32), rnd(9, 4, 2, 32), tbl,
                torch.tensor([16, 16], dtype=torch.int32)), {"window": None}

    def flash_args():
        return (rnd(1, 16, 4, 32), rnd(1, 16, 2, 32), rnd(1, 16, 2, 32)), \
            {"block_q": 8, "block_k": 8, "window": 6}

    def sdm_args():
        planes = [rnd(8, 1024) for _ in range(4)]
        words = [torch.randint(0, 2 ** 31, (8, 1024), generator=g)
                 for _ in range(3)]
        return tuple(planes + words), dict(
            p=0.5, theta=0.25, gamma=0.1, sigma=1.0, clip_c=5.0,
            self_w=0.5, block_rows=8)

    def qsgd_args():
        return (rnd(3, 40), torch.rand(3, 40, generator=g),
                torch.rand(3, generator=g) + 1), {"bits": 4}

    def gather_args():
        return (rnd(3, 10, 16), torch.randint(0, 10, (3, 4), generator=g,
                                              dtype=torch.int32)), \
            {"scale": 2.5}

    return [
        ("paged_decode", paged_attention, decode_args,
         cost.paged_decode([16, 16], window=None, kvh=2, group=4, dh=32,
                           page=4, n_blocks=4, elt_bytes=4)),
        ("flash_attn", flash_attention, flash_args,
         cost.flash_attn(1, 16, 16, 4, 2, 32, causal=True, window=6,
                         elt_bytes=4)),
        ("sdm_update", sdm_update_planes, sdm_args, cost.sdm_update(8 * 1024)),
        ("qsgd_pack", qsgd_pack, qsgd_args, cost.qsgd_pack(3, 40, 4)),
        ("fixedk_gather_pack", fixedk_gather_pack, gather_args,
         cost.fixedk_gather_pack(3, 4, 16)),
    ]


@pytest.mark.parametrize("name", ["paged_decode", "flash_attn", "sdm_update",
                                  "qsgd_pack", "fixedk_gather_pack"])
def test_kernel_meta_branch_charges_its_cost(name):
    [(_, fn, build, want)] = [c for c in _kernel_calls() if c[0] == name]
    args, kw = build()
    cpu = fn(*args, **kw)                       # the plain version
    launches = fn.launches
    meta = tuple(a.to("meta") for a in args)
    with cost.KernelTally() as tally:
        got = fn(*meta, **kw)
    assert tally.calls == {name: 1}
    assert (tally.flops, tally.nbytes) == want
    outs = got if isinstance(got, tuple) else (got,)
    cpus = cpu if isinstance(cpu, tuple) else (cpu,)
    for o, c in zip(outs, cpus):
        assert o.device.type == "meta"
        assert (tuple(o.shape), o.dtype) == (tuple(c.shape), c.dtype)
    assert fn.launches == launches
    # nothing is charged outside a tally, and a CPU call charges nothing
    with cost.KernelTally() as tally:
        fn(*args, **kw)
    assert tally.calls == {} and (tally.flops, tally.nbytes) == (0, 0)
    elsewhere = tuple(a.as_subclass(_Elsewhere) for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*elsewhere, **kw)


def test_flash_pairs_closed_form_equals_the_count():
    for sq, win in [(16, None), (16, 6), (16, 40), (33, 1)]:
        loop = sum(max(0, i - max(0, i - win + 1 if win else 0) + 1)
                   for i in range(sq))
        assert cost.attention_pairs(sq, sq, causal=True, window=win) == loop
    assert cost.attention_pairs(4, 6, causal=False, window=None) == 24


def test_meta_needs_the_opt_in():
    with pytest.raises(ValueError, match="unsupported device meta"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    assert resolve_device("cpu").type == "cpu"
    p = transformer.init_params(configs.get_smoke_config("gemma2-2b"),
                                device="meta")
    assert p["embed"].device.type == "meta"
    from repro_torch.serving import ServingEngine
    with pytest.raises(ValueError, match="unsupported device meta"):
        ServingEngine(configs.get_smoke_config("gemma2-2b"), p,
                      device="meta")


# ---------------------------------------------------------------------------
# bench/roofline
# ---------------------------------------------------------------------------

JAX_RECORD = {
    "arch": "gemma2-2b", "shape": "train_4k", "mesh": "single_pod",
    "algorithm": "sdm-dsgd", "n_devices": 256, "status": "ok",
    "n_periods": 13, "flops": 4.0e13, "bytes_accessed": 2.0e11,
    "collective_bytes": {"collective-permute": 5.0e9, "total": 5.0e9},
    "collective_ops": {"collective-permute": 2},
    "memory": {"peak_memory_in_bytes": 3.0e10},
    "probe1": {"flops": 5.0e12, "bytes_accessed": 3.0e10,
               "collective_bytes": {"total": 4.0e8}},
    "probe2": {"flops": 8.0e12, "bytes_accessed": 5.0e10,
               "collective_bytes": {"total": 7.0e8}},
    "model_params": 2.6e9, "model_params_active": 2.6e9, "n_nodes": 16,
    "per_node_batch": 16, "tokens_per_step": 256 * 4096,
}


def test_roofline_reads_a_jax_record_with_the_h100_constants():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import roofline as jax_roofline
    finally:
        sys.path.remove(str(ROOT))
    got = roofline.analyze_record(JAX_RECORD)
    want = jax_roofline.analyze_record(JAX_RECORD)
    assert list(got) == list(want)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    flops = 5.0e12 + 12 * 3.0e12
    nbytes = 3.0e10 + 12 * 2.0e10
    coll = 4.0e8 + 12 * 3.0e8
    assert got["compute_s"] == round(flops / 989e12, 6)
    assert got["memory_s"] == round(nbytes / 3.35e12, 6)
    assert got["collective_s"] == round(coll / 450e9, 6)
    assert got["dominant"] == "memory"
    for k in ("arch", "shape", "mesh", "algorithm", "chips", "model_flops",
              "hlo_flops_total", "useful_flop_ratio", "peak_memory_per_dev"):
        assert got[k] == want[k], k
    # a port record has no probes: its raw values are the terms
    port = {k: v for k, v in JAX_RECORD.items()
            if k not in ("probe1", "probe2")}
    assert roofline.analyze_record(port)["compute_s"] == round(
        4.0e13 / 989e12, 6)
    assert roofline.analyze_record({"status": "skipped"}) is None
