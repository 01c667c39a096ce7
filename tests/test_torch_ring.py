"""PyTorch port: the ring gossip helpers against the JAX package's.

The JAX helpers (``repro.core.gossip.ring_exchange``,
``ring_weighted_neighbor_sum``, ``ring_exchange_packed`` and
``ring_exchange_packed_rows``) run under ``shard_map`` on 8 faked CPU
devices in a subprocess this test starts itself (``XLA_FLAGS`` must be
set before jax imports), one node a device; their outputs come back as
npz. The port's helpers run on ``StackTransport(8, "cpu")`` (all nodes as
one block) on the same numpy inputs and keys:

- ``ring_exchange`` bit-equal;
- the weighted and packed helpers within 1e-6 relative, the packed one
  at block 1 and 4 (a padded last block);
- the transport's counters: two sends a round, each carrying the
  payload (the packed (kb, block) values only).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[1]
N, SEED, STEP, P, W = 8, 42, 3, 0.3, 0.25
DIM = 1001                       # not a multiple of 4: block 4 pads
ROWS, COLS = 37, 16


def inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(N, 5, 7)).astype(np.float32),
            "d": rng.normal(size=(N, DIM)).astype(np.float32),
            "r": rng.normal(size=(N, ROWS, COLS)).astype(np.float32)}


def _jax_main(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P_

    from repro import compat
    from repro.core import gossip

    mesh = compat.make_mesh((N,), ("data",))
    key = jax.random.PRNGKey(SEED)

    def per_node(fn, n_out):
        def inner(v):
            out = fn(v[0])
            out = out if isinstance(out, tuple) else (out,)
            return tuple(o[None] for o in out)
        return jax.jit(compat.shard_map(
            inner, mesh=mesh, in_specs=(P_("data"),),
            out_specs=(P_("data"),) * n_out, axis_names={"data"},
            check_vma=False))

    ins = {k: jnp.asarray(v) for k, v in inputs().items()}
    out = {}
    out["left"], out["right"] = per_node(
        lambda v: gossip.ring_exchange(v, "data"), 2)(ins["x"])
    out["wsum"], = per_node(
        lambda v: gossip.ring_weighted_neighbor_sum(v, "data", W), 1)(ins["x"])
    for block in (1, 4):
        out[f"own{block}"], out[f"nb{block}"] = per_node(
            lambda v, block=block: gossip.ring_exchange_packed(
                v, axis_name="data", base_key=key, step=STEP, p=P,
                neighbor_weight=W, block=block), 2)(ins["d"])
    out["own_rows"], out["nb_rows"] = per_node(
        lambda v: gossip.ring_exchange_packed_rows(
            v, axis_name="data", base_key=key, step=STEP, p=P,
            neighbor_weight=W), 2)(ins["r"])
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_ring") / "ring.npz"
    proc = subprocess.run(
        [sys.executable, str(HERE), "--jax", str(out)], capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _transport():
    from repro_torch.core.transport import StackTransport

    return StackTransport(N, "cpu")


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_ring_exchange_is_jax_s(jax_results):
    from repro_torch.core import gossip

    t = _transport()
    x = torch.from_numpy(inputs()["x"])
    left, right = gossip.ring_exchange(x, t)
    assert np.array_equal(left.numpy(), jax_results["left"])
    assert np.array_equal(right.numpy(), jax_results["right"])
    assert torch.equal(left, torch.roll(x, 1, dims=0))
    assert torch.equal(right, torch.roll(x, -1, dims=0))
    assert t.permutes == 2
    assert t.bytes_sent == {i: 2 * 5 * 7 * 4 for i in range(N)}


def test_ring_weighted_neighbor_sum_matches_jax(jax_results):
    from repro_torch.core import gossip

    t = _transport()
    got = gossip.ring_weighted_neighbor_sum(
        torch.from_numpy(inputs()["x"]), t, W)
    assert _rel(got.numpy(), jax_results["wsum"]) <= 1e-6
    assert t.permutes == 2


@pytest.mark.parametrize("block", [1, 4])
def test_ring_exchange_packed_matches_jax(jax_results, block):
    from repro_torch import prng
    from repro_torch.core import gossip, sparsifier

    t = _transport()
    own, nb = gossip.ring_exchange_packed(
        torch.from_numpy(inputs()["d"]), transport=t,
        base_key=prng.PRNGKey(SEED), step=STEP, p=P, neighbor_weight=W,
        block=block)
    assert own.shape == nb.shape == (N, DIM)
    assert _rel(own.numpy(), jax_results[f"own{block}"]) <= 1e-6
    assert _rel(nb.numpy(), jax_results[f"nb{block}"]) <= 1e-6
    kb = sparsifier.num_kept(-(-DIM // block), P)
    assert t.permutes == 2
    assert t.bytes_sent == {i: 2 * kb * block * 4 for i in range(N)}


def test_ring_exchange_packed_rows_matches_jax(jax_results):
    from repro_torch import prng
    from repro_torch.core import gossip, sparsifier

    t = _transport()
    own, nb = gossip.ring_exchange_packed_rows(
        torch.from_numpy(inputs()["r"]), transport=t,
        base_key=prng.PRNGKey(SEED), step=STEP, p=P, neighbor_weight=W)
    assert own.shape == nb.shape == (N, ROWS, COLS)
    assert _rel(own.numpy(), jax_results["own_rows"]) <= 1e-6
    assert _rel(nb.numpy(), jax_results["nb_rows"]) <= 1e-6
    kb = sparsifier.num_kept(ROWS, P)
    # each node keeps exactly kb whole rows of its own differential
    assert all(int((own[i].abs().sum(-1) > 0).sum()) == kb
               for i in range(N))
    assert t.permutes == 2
    assert t.bytes_sent == {i: 2 * kb * COLS * 4 for i in range(N)}


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main(sys.argv[2])
