"""PyTorch port: the per-node executor against the JAX package's.

The JAX package's shard_map executor (``method.make_distributed``) runs
live in a subprocess this test starts itself: ``XLA_FLAGS`` fakes 8 CPU
devices before jax imports (as ``tests/test_distributed.py`` does),
the cases and inputs come from ``tests/helpers/method_parity_check.py``
(parity contract 5) and the final public copies come back as npz. The
port's executor runs the same cases on a ``StackTransport`` (all nodes
as one block) from the same numpy inputs and keys, and must agree at
the JAX package's own parity tolerance: 1e-4 of max(scale, 1), 1e-3 for
the QSGD quantizers (a norm summed in another order can flip one
stochastic level).

For every case the port's executor is also held against the port's own
``ReferenceSimulator`` / ``DSGDReference`` / ``GradientPushReference``,
the transport's counters against ``wire_count`` (ppermute calls; bytes
sent per node, for the deterministic wire formats), and the overlapped
cases against the one-step-stale oracle of
``tests/helpers/dense_oracle.py``. Gradient-push cases compare the
de-biased z = x / w (what the JAX sweep compares); the port's
``GradientPushReference`` is also held to the JAX package's on noisy,
clipped trajectories, and compressed push-sum to its mass-conservation
invariant (the JAX sweep's ``push_conservation_probe``).

Not run here (it stays with the JAX package's own sweep): the "plane"
group (multi-leaf trees: covered by the LM executor in
test_torch_lm_train.py).
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# (group of method_parity_check.CASES, method key, topology, mode)
CASES = [
    ("sdm_core", "sdm-dsgd", "ring8", "bernoulli"),
    ("sdm_core", "sdm-dsgd", "ring8", "fixedk_packed"),
    ("sdm_core", "sdm-dsgd", "ring8", "fixedk_rows"),
    ("sdm_core", "sdm-dsgd", "torus2x2", "bernoulli"),
    ("sdm_core", "sdm-dsgd", "torus2x2", "fixedk_packed"),
    ("sdm_core", "sdm-dsgd", "er8", "fixedk_packed"),
    ("sdm_core", "sdm-dsgd", "star4", "bernoulli"),
    ("sdm_variants", "sdm-dsgd-fused", "ring8", "fixedk_rows"),
    ("sdm_variants", "sdm-dsgd-fused", "torus2x2", "fixedk_packed"),
    ("sdm_variants", "dc-dsgd", "torus2x2", "bernoulli"),
    ("sdm_variants", "dc-dsgd", "ring8", "fixedk_packed"),
    ("sdm_variants", "sdm-dsgd", "matchings8x3", "bernoulli"),
    ("sdm_variants", "sdm-dsgd", "matchings8x3", "fixedk_packed"),
    ("sdm_variants", "sdm-dsgd:het", "ring8", "bernoulli"),
    ("time_varying", "sdm-dsgd", "matchings8x2", "bernoulli"),
    ("time_varying", "sdm-dsgd", "matchings8x2", "fixedk_packed"),
    ("time_varying", "sdm-dsgd", "matchings8x2", "qsgd"),
    ("time_varying", "sdm-dsgd-fused", "matchings8x2", "fixedk_packed"),
    ("compressed", "sdm-dsgd", "ring8", "qsgd"),
    ("compressed", "sdm-dsgd", "ring8", "qsgd:4"),
    ("compressed", "sdm-dsgd:het", "ring8", "fixedk_packed"),
    ("compressed", "sdm-dsgd:het", "torus2x2", "fixedk_packed"),
    ("overlap", "sdm-dsgd:ov", "ring8", "bernoulli"),
    ("overlap", "sdm-dsgd:ov", "ring8", "fixedk_packed"),
    ("overlap", "sdm-dsgd:ov", "ring8", "qsgd:4"),
    ("overlap", "sdm-dsgd:ov", "ring8", "qsgdf:4"),
    ("overlap", "sdm-dsgd-fused:ov", "ring8", "fixedk_packed"),
    ("baselines", "dsgd", "ring8", "-"),
    ("baselines", "dsgd", "er8", "-"),
    ("baselines", "dsgd", "matchings8x3", "-"),
    ("baselines", "allreduce", "ring8", "-"),
    ("baselines", "allreduce", "er8", "-"),
    ("baselines", "gradient-push", "dring8", "-"),
    ("baselines", "gradient-push", "der8", "-"),
    ("compressed", "gradient-push", "dring8", "bernoulli"),
    ("compressed", "gradient-push", "dring8", "fixedk"),
    ("compressed", "gradient-push", "der8", "fixedk"),
    ("compressed", "gradient-push", "der8", "qsgd"),
    ("compressed", "gradient-push", "dring8", "qsgdf:4"),
    ("time_varying", "gradient-push", "matchings8x2", "bernoulli"),
    ("time_varying", "gradient-push", "matchings8x2", "fixedk"),
    ("time_varying", "gradient-push", "matchings8x2", "qsgd"),
    ("overlap", "gradient-push:ov", "dring8", "fixedk"),
]

DIM, STEPS, SEED = 5 * 128, 12, 42   # method_parity_check's DIM/STEPS/key


def case_id(key, topo, mode):
    return f"{key}|{topo}|{mode}"


def inputs(n):
    """method_parity_check.run_case's single-leaf least-squares inputs."""
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(n, 16, DIM)) / 4.0).astype(np.float32)
    b = rng.normal(size=(n, 16)).astype(np.float32)
    p0 = (rng.normal(size=(DIM,)) * 0.1).astype(np.float32)
    return a, b, p0


# --------------------------------------------------------------------------
# The JAX side: run in a subprocess (python tests/test_torch_distributed.py
# --jax OUT.npz); 8 faked CPU devices must be set before jax imports.
# --------------------------------------------------------------------------

def _jax_main(out_path: str) -> None:
    sys.path[:0] = [str(HERE / "helpers"), str(ROOT / "src")]
    import method_parity_check as mpc   # sets XLA_FLAGS, then imports jax

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dense_oracle import sdm_dense_overlap_oracle
    from repro import compat
    from repro.core import method as method_mod

    assert (mpc.DIM, mpc.STEPS) == (DIM, STEPS)
    key = jax.random.PRNGKey(SEED)
    out = {}
    for group, mkey, topo, mode in CASES:
        assert (mkey, topo, mode) in mpc.CASES[group], (group, mkey, topo)
        name = mkey.split(":")[0]
        meth = method_mod.get(name)
        seq = mpc.parse_seq(topo)
        n = seq.n_nodes
        cfg = mpc.make_cfg(mkey, meth, mode, n)
        a, b, p0 = (jnp.asarray(v) for v in inputs(n))
        stack = {"w": jnp.broadcast_to(p0, (n, DIM))}

        def node_grad(w, a_, b_):
            r = a_ @ w - b_
            return a_.T @ r / a_.shape[0]

        ex = meth.make_distributed(seq, cfg, "data")

        def inner(p, a_, b_, ex=ex, node_grad=node_grad):
            p = jax.tree.map(lambda v: jnp.squeeze(v, 0), p)
            a_, b_ = jnp.squeeze(a_, 0), jnp.squeeze(b_, 0)
            state = ex.init(p, jax.lax.axis_index("data"))

            def body(state, _):
                state, _ = ex.step(
                    state, lambda pp: ({"w": node_grad(pp["w"], a_, b_)},
                                       jnp.float32(0.0)), base_key=key)
                return state, None

            state, _ = jax.lax.scan(body, state, None, length=STEPS)
            return jax.tree.map(lambda v: v[None],
                                mpc.debias(name, state.x, state))

        mesh = compat.make_mesh((n,), ("data",))
        fn = compat.shard_map(inner, mesh=mesh,
                              in_specs=(P("data"), P("data"), P("data")),
                              out_specs=P("data"), axis_names={"data"},
                              check_vma=False)
        cid = case_id(mkey, topo, mode)
        out[cid] = np.asarray(jax.jit(fn)(stack, a, b)["w"])
        if mkey == "sdm-dsgd:ov":
            grad_stack = jax.vmap(node_grad)
            out[cid + "|oracle"] = sdm_dense_overlap_oracle(
                seq, cfg, stack["w"], lambda x: grad_stack(x, a, b), STEPS,
                key)
    np.savez(out_path, **out)


# --------------------------------------------------------------------------
# The port's side.
# --------------------------------------------------------------------------

torch = pytest.importorskip("torch")


def parse_seq(spec, gossip=None, topology=None):
    """method_parity_check.parse_seq on the port's topology copy (or on
    the ``gossip`` / ``topology`` modules given)."""
    if gossip is None:
        from repro_torch.core import gossip, topology

    m = re.fullmatch(r"matchings(\d+)x(\d+)", spec)
    if m:
        return gossip.sequence_from_topologies(
            topology.random_matchings(int(m.group(1)), int(m.group(2)),
                                      seed=0), name=spec)
    family, size = re.fullmatch(r"([a-z]+)(\d+(?:x\d+)?)", spec).groups()
    if family == "torus":
        topo = topology.torus_2d(*(int(v) for v in size.split("x")))
    else:
        topo = topology.by_name(family, int(size))
    return gossip.ensure_sequence(gossip.schedule_from_topology(topo))


def make_cfg(mkey, meth, mode, n):
    """method_parity_check.make_cfg on the port's config classes."""
    from repro_torch.core import baselines, gradient_push, sdm_dsgd

    if meth.config_cls is gradient_push.GradientPushConfig:
        # a non-"-" mode is a compressor spec: the error-compensated
        # compressed push-sum variant
        return gradient_push.GradientPushConfig(
            gamma=0.2, compressor=None if mode == "-" else mode, p=0.25,
            overlap=mkey.endswith(":ov"))
    if meth.config_cls is not sdm_dsgd.SDMConfig:
        return baselines.DSGDConfig(gamma=0.2)
    p = tuple(0.15 + 0.05 * (i % 4) for i in range(n)) \
        if mkey.endswith(":het") else 0.25
    kw = dict(p=p, theta=0.15, gamma=0.2, sigma=0.0, clip_c=1.0,
              overlap=mkey.endswith(":ov"))
    if mode.startswith("qsgd:") or mode.split(":")[0] == "qsgdf":
        return meth.coerce_config(sdm_dsgd.SDMConfig(compressor=mode, **kw))
    return meth.coerce_config(sdm_dsgd.SDMConfig(mode=mode, **kw))


def run_port(mkey, topo, mode):
    """(port executor x, port reference x, transport, meth, cfg, seq)."""
    from repro_torch import prng
    from repro_torch.core import method as method_mod, transport as tr

    name = mkey.split(":")[0]
    meth = method_mod.get(name)
    seq = parse_seq(topo)
    n = seq.n_nodes
    cfg = make_cfg(mkey, meth, mode, n)
    a, b, p0 = (torch.from_numpy(v) for v in inputs(n))

    def grads(tree):   # per node, one matrix-vector product at a time
        w = tree["w"]
        return {"w": torch.stack([a[i].T @ (a[i] @ w[i] - b[i]) / 16
                                  for i in range(n)])}

    key = prng.PRNGKey(SEED)
    transport = tr.StackTransport(n, "cpu")
    ex = meth.make_distributed(seq, cfg, transport)
    state = ex.init({"w": p0.expand(n, DIM).clone()})
    for _ in range(STEPS):
        state, _ = ex.step(state, lambda x: (grads(x), 0.0), base_key=key)

    sim = meth.make_reference(seq, cfg)
    ref = sim.init({"w": p0.expand(n, DIM).clone()})
    for _ in range(STEPS):
        if hasattr(sim, "advance"):
            ref, _ = sim.advance(ref, key)
            ref = sim.commit(ref, grads(ref.x), key)
        else:
            ref, _ = sim.step(ref, lambda x, _b: (grads(x), 0.0), None, key)
    if name == "sdm-dsgd-fused":
        ref, _ = sim.advance(ref, key)
    if name == "gradient-push":       # compare the de-biased z = x / w
        from repro_torch.core.gradient_push import _debias

        return (_debias(state.x, state.w)["w"].numpy(),
                sim.eval_params(ref)["w"].numpy(), transport, meth, cfg, seq,
                p0)
    return (state.x["w"].numpy(), ref.x["w"].numpy(), transport, meth, cfg,
            seq, p0)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_exec") / "dist.npz"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--jax",
         str(out)], capture_output=True, text=True, timeout=900,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("group,mkey,topo,mode", CASES,
                         ids=[case_id(*c[1:]) for c in CASES])
def test_executor_matches_jax_executor(jax_results, group, mkey, topo,
                                       mode):
    from repro_torch.core import wire_count

    got, ref, transport, meth, cfg, seq, p0 = run_port(mkey, topo, mode)
    cid = case_id(mkey, topo, mode)
    want = jax_results[cid]
    scale = float(np.max(np.abs(want)))
    assert scale > 0.01                                 # the run moved
    tol = 1e-3 if "qsgd" in mode else 1e-4
    err = float(np.max(np.abs(got - want)))
    assert err < tol * max(scale, 1.0), (cid, err)
    # the port's executor against the port's reference (same package:
    # only the mixing's f32 summation order differs)
    assert float(np.max(np.abs(got - ref))) <= 1e-5 * max(scale, 1.0)
    if cid + "|oracle" in jax_results:                  # one-step-stale
        oracle = jax_results[cid + "|oracle"]
        assert float(np.max(np.abs(got - oracle))) < 1e-4 * max(scale, 1.0)

    # parity contract 3: the sends and the bytes
    name = meth.name
    mode_s = wire_count.mode_of(name, cfg)
    calls = sum(wire_count.permutes_per_step(name, mode_s, seq, t)
                for t in range(STEPS))
    assert transport.permutes == calls
    if seq.length == 1:
        assert calls == STEPS * wire_count.expected_permutes(name, mode_s,
                                                             seq)
    deterministic = mode_s != "bernoulli" and not isinstance(
        getattr(cfg, "p", None), tuple)
    if deterministic:
        # gradient-push's fixed-k indices ship as int32, wider than the
        # accounting's ceil(log2 d) bits (wire_count.INDEX_WIRE_BITS)
        assert transport.bytes_sent == wire_count.expected_bytes_sent(
            meth, {"w": p0}, cfg, seq, STEPS)
    assert (transport.permutes > 0) == (name != "allreduce")


def test_overlap_diverges_from_the_plain_transport():
    """The one-step-stale transport is a real change, not a no-op flag."""
    on, _, *_ = run_port("sdm-dsgd:ov", "ring8", "fixedk_packed")
    off, _, *_ = run_port("sdm-dsgd", "ring8", "fixedk_packed")
    assert float(np.max(np.abs(on - off))) > 1e-4


# (topology, compressor or None, overlap): static, directed, time-varying
PUSH_REF_CASES = [("der8", None, False), ("dring8", "fixedk", False),
                  ("der8", "qsgdf:4", False), ("matchings8x2", "bernoulli",
                                               False),
                  ("dring8", "fixedk", True)]


@pytest.mark.parametrize("topo,comp,overlap", PUSH_REF_CASES,
                         ids=[f"{t}|{c}|ov{int(o)}"
                              for t, c, o in PUSH_REF_CASES])
def test_push_reference_matches_jax_reference(topo, comp, overlap):
    """The port's GradientPushReference against the JAX package's on the
    same inputs and keys, with clipping and Gaussian noise on (the
    parity sweep runs noise-free): de-biased z, mass w and the consensus
    at 1e-4 of max(scale, 1) after 12 steps of run_decentralized's key
    chain."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import gossip as jgossip, gradient_push as jgp
    from repro.core import topology as jtopology
    from repro_torch import prng
    from repro_torch.core import gradient_push as tgp

    seq_t = parse_seq(topo)
    seq_j = parse_seq(topo, jgossip, jtopology)
    n = seq_t.n_nodes
    kw = dict(gamma=0.2, sigma=0.5, clip_c=1.0, compressor=comp, p=0.25,
              overlap=overlap)
    sim_t = tgp.GradientPushReference(seq_t, tgp.GradientPushConfig(**kw))
    sim_j = jgp.GradientPushReference(seq_j, jgp.GradientPushConfig(**kw))
    a, b, p0 = inputs(n)

    def grads_t(z, _):
        w = z["w"]
        return {"w": torch.stack([torch.from_numpy(a[i]).T @ (
            torch.from_numpy(a[i]) @ w[i] - torch.from_numpy(b[i])) / 16
            for i in range(n)])}, 0.0

    def grads_j(z, _):
        r = jnp.einsum("nbd,nd->nb", a, z["w"]) - b
        return {"w": jnp.einsum("nbd,nb->nd", a, r) / 16}, 0.0

    st_t = sim_t.init({"w": torch.from_numpy(p0).expand(n, DIM).clone()})
    st_j = sim_j.init({"w": jnp.broadcast_to(jnp.asarray(p0), (n, DIM))})
    key_t, key_j = prng.PRNGKey(SEED), jax.random.PRNGKey(SEED)
    for _ in range(STEPS):
        key_t, sub_t = prng.split(key_t)
        key_j, sub_j = jax.random.split(key_j)
        st_t, _ = sim_t.step(st_t, grads_t, None, sub_t)
        st_j, _ = sim_j.step(st_j, grads_j, None, sub_j)
    z_t = sim_t.eval_params(st_t)["w"].numpy()
    z_j = np.asarray(sim_j.eval_params(st_j)["w"])
    scale = max(float(np.max(np.abs(z_j))), 1.0)
    assert float(np.max(np.abs(z_t - z_j))) < 1e-4 * scale
    assert np.allclose(st_t.w.numpy(), np.asarray(st_j.w), atol=1e-6)
    cons_t = sim_t.consensus(st_t)["w"].numpy()
    cons_j = np.asarray(sim_j.consensus(st_j)["w"])
    assert float(np.max(np.abs(cons_t - cons_j))) < 1e-4 * scale


@pytest.mark.parametrize("topo,mode", [("matchings8x2", "fixedk"),
                                       ("der8", "qsgd"),
                                       ("dring8", "qsgdf:4")])
def test_compressed_push_conserves_mass(topo, mode):
    """The JAX sweep's ``push_conservation_probe`` on the port: pure
    gossip (gamma = sigma = 0) must keep sum x / sum w at the initial mean
    on every step, and the de-biased estimates must reach it."""
    from repro_torch import prng
    from repro_torch.core import gradient_push as tgp, method as method_mod

    seq = parse_seq(topo)
    cfg = tgp.GradientPushConfig(gamma=0.0, sigma=0.0, compressor=mode,
                                 p=0.4)
    sim = method_mod.get("gradient-push").make_reference(seq, cfg)
    rng = np.random.default_rng(5)
    stack = {"w": torch.from_numpy(rng.normal(size=(seq.n_nodes, 6)).astype(
        np.float32))}
    mean0 = stack["w"].mean(dim=0).numpy()
    state = sim.init(stack)
    key = prng.PRNGKey(0)
    mass_err = 0.0
    for _ in range(200):
        key, sub = prng.split(key)
        state, _ = sim.step(state, lambda p, _b: (
            {k: torch.zeros_like(v) for k, v in p.items()}, 0.0), None, sub)
        cons = sim.consensus(state)["w"].numpy()
        mass_err = max(mass_err, float(np.max(np.abs(cons - mean0))))
    z = sim.eval_params(state)["w"].numpy()
    assert mass_err < 1e-4
    assert float(np.max(np.abs(z - mean0))) < 0.05


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main(sys.argv[2])
