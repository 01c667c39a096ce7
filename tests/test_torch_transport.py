"""PyTorch port: the node transports of the per-node executor.

- ``StackTransport``: ``ppermute`` has ``lax.ppermute``'s semantics (the
  receiver of each (src, dst) pair gets the sender's row, a node that
  is no destination gets zeros); its counters count every call and the
  bytes each node sends; ``pmean`` averages over the nodes.
- ``ProcessGroupTransport`` on gloo, 4 spawned CPU processes (one node
  each): the same ppermute semantics and counters, and an SDM-DSGD run
  (fixedk_packed, qsgdf:4 and a time-varying replica case, sigma > 0)
  bit-equal to the same run with all 4 nodes on one ``StackTransport``.
- The same on NCCL, one process per GPU, against a ``StackTransport`` on
  the first GPU: marked ``cuda``, it runs on a machine with 4 GPUs
  (``pytest -m cuda tests/test_torch_transport.py``) and skips elsewhere.

The workers are this file run as a script
(``--worker BACKEND RANK PORT OUT``).
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD, STEPS = 4, 4
# (method, topology spec, compressor)
RUNS = [("sdm-dsgd", "ring", "fixedk"), ("sdm-dsgd", "ring", "qsgdf:4"),
        ("sdm-dsgd-fused", "matchings:2", "fixedk")]
SHAPES = {"w1": (9, 33), "b1": (71,), "w2": (3, 5, 11)}


def _run(meth_name, topo, comp, transport):
    """STEPS executor steps on the transport's node block; returns the
    final state as {name: (L, ...) numpy}."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import gossip, method, sdm_dsgd

    rng = np.random.default_rng(3)
    targets = {k: rng.normal(size=(WORLD,) + s).astype(np.float32)
               for k, s in SHAPES.items()}
    p0 = {k: (0.1 * v[0] + 0.05) for k, v in targets.items()}
    nodes = transport.me.tolist()
    dev = transport.device
    tgt = {k: torch.from_numpy(v[nodes]).to(dev) for k, v in targets.items()}
    block = {k: torch.from_numpy(np.broadcast_to(v, (len(nodes),) + v.shape)
                                 .copy()).to(dev) for k, v in p0.items()}
    seq = gossip.sequence_by_name(topo, WORLD)
    meth = method.get(meth_name)
    cfg = meth.coerce_config(sdm_dsgd.SDMConfig(
        p=0.3, theta=0.4, gamma=0.1, sigma=0.05, clip_c=1.0,
        compressor=comp))
    ex = meth.make_distributed(seq, cfg, transport)
    state = ex.init(block)
    for _ in range(STEPS):
        state, _ = ex.step(
            state, lambda x: (tree_mod.tree_map(torch.sub, x, tgt), None),
            base_key=prng.PRNGKey(7))
    out = {f"x/{k}": v for k, v in tree_mod.flatten_with_paths(state.x)
           .items()}
    out.update({f"s/{i}": v for i, v in enumerate(state.s)})
    for i, v in enumerate(getattr(state, "d", None) or ()):
        out[f"d/{i}"] = v
    for i, v in enumerate(state.xhat or ()):
        out[f"xhat/{i}"] = v
    return {k: v.cpu().numpy() for k, v in out.items()}


def _probe(transport):
    """One partial-permutation round and one pmean on rows rank * 10 + j."""
    me = transport.me
    rows = me.to(torch.float32)[:, None] * 10 + torch.arange(
        3.0, device=me.device)[None]
    got = transport.ppermute(rows, ((0, 2), (2, 1), (3, 0)))
    return got.cpu().numpy(), transport.pmean(rows).cpu().numpy()


def _worker(backend: str, rank: int, port: int, out: str) -> None:
    import faulthandler

    import torch.distributed as dist

    faulthandler.dump_traceback_later(120, exit=True)   # a hang shows where

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.transport import ProcessGroupTransport

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        t = ProcessGroupTransport()
        res = {}
        res["probe"], res["pmean"] = _probe(t)
        res["probe_permutes"] = np.asarray(t.permutes)
        wrong = "cuda" if backend == "gloo" else "cpu"
        if wrong == "cpu" or torch.cuda.is_available():
            with pytest.raises(ValueError):   # the backend's device only
                t.ppermute(torch.zeros(1, 3, device=wrong), ((0, 1),))
        for i, run in enumerate(RUNS):
            t.reset_counters()
            for k, v in _run(*run, t).items():
                res[f"{i}/{k}"] = v
            res[f"{i}/permutes"] = np.asarray(t.permutes)
            res[f"{i}/bytes"] = np.asarray(t.bytes_sent[rank])
        np.savez(out, **res)
        dist.barrier()
    finally:
        if backend == "nccl":
            # on the card, destroy_process_group hung on rank 0 after every
            # rank had saved its results (NCCL 2.28.9); what this test
            # checks is the data path, so the worker ends without it
            os._exit(0)
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


def test_stack_transport_ppermute_semantics_and_counters():
    from repro_torch.core.transport import StackTransport

    t = StackTransport(WORLD, "cpu")
    got, mean = _probe(t)
    want = np.zeros((WORLD, 3), np.float32)
    want[2], want[1], want[0] = [0, 1, 2], [20, 21, 22], [30, 31, 32]
    assert np.array_equal(got, want)                 # node 3: zeros
    assert np.allclose(mean, np.full((WORLD, 3), 15.0) + np.arange(3.0))
    assert t.permutes == 1
    assert t.bytes_sent == {0: 12, 1: 0, 2: 12, 3: 12}
    t.ppermute(torch.zeros(WORLD, 5, dtype=torch.uint8), ((1, 2),))
    assert t.permutes == 2 and t.bytes_sent[1] == 5
    t.reset_counters()
    assert t.permutes == 0 and set(t.bytes_sent.values()) == {0}
    with pytest.raises(ValueError):                  # not a block of 4
        t.ppermute(torch.zeros(3, 2), ((0, 1),))


def test_stack_transport_defaults_to_the_card():
    """Like every entry point, the stack transport targets CUDA unless the
    caller asks for the CPU: without a card the default raises."""
    from repro_torch.core.transport import StackTransport

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StackTransport(WORLD)
    assert StackTransport(WORLD, "cpu").device == torch.device("cpu")


def test_payload_indices_cross_as_int32():
    """Explicit indices ship at lax.top_k's int32 width (4 bytes each on
    the counters) and come back in their own dtype, unchanged."""
    from repro_torch.core import gossip
    from repro_torch.core.compressor import Payload
    from repro_torch.core.transport import StackTransport

    t = StackTransport(WORLD, "cpu")
    idx = torch.arange(WORLD * 3, dtype=torch.int64).reshape(WORLD, 3) * 7
    vals = torch.ones(WORLD, 3, 2)
    perm = ((0, 1), (1, 2), (2, 3), (3, 0))
    got = gossip._ppermute_payload(t, Payload(values=vals, indices=idx),
                                   perm)
    assert got.indices.dtype == torch.int64
    assert torch.equal(got.indices, torch.roll(idx, 1, dims=0))
    assert t.permutes == 2
    assert t.bytes_sent == {i: 3 * 2 * 4 + 3 * 4 for i in range(WORLD)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_and_compare(backend: str, tmp_path, stack) -> None:
    """WORLD workers on ``backend``, each holding one node; every result
    bit-equal to the same work on ``stack`` (all nodes as one block)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    if backend == "nccl":
        # the workers meet on the loopback interface, which NCCL's socket
        # bootstrap skips unless told
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    outs = [tmp_path / f"rank{r}.npz" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         backend, str(r), str(port), str(outs[r])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=150)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.communicate()[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    ranks = []
    for o in outs:
        with np.load(o) as data:
            ranks.append({k: data[k] for k in data.files})

    probe, mean = _probe(stack)
    for r, res in enumerate(ranks):
        assert np.array_equal(res["probe"][0], probe[r])
        assert np.allclose(res["pmean"][0], mean[r])
        assert int(res["probe_permutes"]) == 1
    for i, run in enumerate(RUNS):
        stack.reset_counters()
        want = _run(*run, stack)
        for r, res in enumerate(ranks):
            for k, v in want.items():
                got = res[f"{i}/{k}"]
                assert got.shape == (1,) + v.shape[1:], (run, k)
                assert np.array_equal(got[0].view(np.uint32),
                                      v[r].view(np.uint32)), (run, r, k)
            assert int(res[f"{i}/permutes"]) == stack.permutes
            assert int(res[f"{i}/bytes"]) == stack.bytes_sent[r] > 0


def test_process_group_transport_gloo_is_bit_equal_to_stack(tmp_path):
    from repro_torch.core.transport import StackTransport

    _spawn_and_compare("gloo", tmp_path, StackTransport(WORLD, "cpu"))


@pytest.mark.cuda
def test_process_group_transport_nccl_is_bit_equal_to_stack(tmp_path):
    from repro_torch.core.transport import StackTransport

    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices (NCCL refuses two ranks "
                    "on one device)")
    _spawn_and_compare("nccl", tmp_path, StackTransport(WORLD, "cuda:0"))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
