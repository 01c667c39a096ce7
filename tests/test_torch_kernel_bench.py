"""PyTorch port: the kernel-bench entry point against the JAX script.

``repro_torch.bench.kernel_bench.run_gossip_schedules`` must print the
same line names and the same derived columns (rounds, degrees, dense /
packed wire bytes and bits: structural quantities) as
``benchmarks/kernel_bench.py``, string for string, at small sizes on the
CPU. ``run_sdm_update`` and ``run_flash`` run on the plain path here and
print their lines; the CLI does the same.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.bench import common, kernel_bench  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _lines(out: str):
    return [line.split(",", 2) for line in out.strip().splitlines()]


@pytest.mark.parametrize("n_nodes,d", [(8, 1 << 12), (16, 5000)])
def test_gossip_schedule_columns_equal_jax(capsys, n_nodes, d):
    from benchmarks import kernel_bench as jbench

    jbench.run_gossip_schedules(n_nodes=n_nodes, d=d, p=0.1)
    want = _lines(capsys.readouterr().out)
    kernel_bench.run_gossip_schedules(n_nodes=n_nodes, d=d, p=0.1,
                                      device="cpu")
    got = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == len(kernel_bench.GOSSIP_TOPOLOGIES)
    for (gname, gus, gder), (wname, _, wder) in zip(got, want):
        assert gname == wname
        assert gder == wder
        assert float(gus) > 0


def test_sdm_update_and_flash_lines_on_the_plain_path(capsys):
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.sdm_update import sdm_update_planes

    n_sdm, n_flash = sdm_update_planes.launches, flash_attention.launches
    ops, kw = kernel_bench.run_sdm_update(rows=32, device="cpu")
    q, k, v = kernel_bench.run_flash(s=128, h=2, kvh=1, dh=32, device="cpu")
    got = _lines(capsys.readouterr().out)
    assert [g[0] for g in got] == ["sdm_update_plain", "sdm_update_cpu_plain",
                                   "flash_attn_plain", "flash_attn_cpu_plain"]
    assert got[0][2] == (f"bytes/call={10 * 32 * 1024 * 4};"
                         "fused_tensor_touches=10_vs_22")
    assert got[2][2] == (f"dense_scores_bytes={2 * 128 * 128 * 4};"
                         "flash_tile_bytes=16384")
    assert all(float(g[1]) > 0 for g in got)
    # what each returns is what it timed: the wrapper's call on it
    assert [tuple(t.shape) for t in ops] == [(32, 1024)] * 7
    assert [t.dtype for t in ops] == [torch.float32] * 4 + [torch.int32] * 3
    assert kw["block_rows"] == 32 and kw["p"] == 0.25
    assert all(torch.isfinite(t).all() for t in sdm_update_planes(*ops, **kw))
    assert (q.shape, k.shape, v.shape) == ((1, 128, 2, 32),
                                           (1, 128, 1, 32), (1, 128, 1, 32))
    # the CPU never launches a kernel
    assert sdm_update_planes.launches == n_sdm
    assert flash_attention.launches == n_flash


def test_timeit_and_emit_format(capsys):
    calls = []
    us = common.timeit_us(lambda x: calls.append(x), torch.zeros(2),
                          iters=5, warmup=2)
    assert len(calls) == 7 and us >= 0
    common.emit("name", 12.345, "a=1;b=2")
    assert capsys.readouterr().out == "name,12.3,a=1;b=2\n"


def test_cli_topology_and_cpu_device():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.kernel_bench",
         "--topology", "der:0.35", "--nodes", "8", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    (name, _, derived), = _lines(out.stdout)
    assert name == "gossip_schedule_der8_pc0.35_s0"
    assert derived.startswith("rounds=7;seq_len=1;mean_degree=3.25;")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        kernel_bench.run_sdm_update(rows=8)


def test_mlr_testbed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.make_mlr_testbed(n_train=500)


def test_mlr_testbed_shapes():
    topo, stack, grad_fn, eval_fn, batches, m_local = \
        common.make_mlr_testbed(n_train=500, topology_spec="der:0.35",
                                device="cpu")
    assert topo.n_nodes == common.N_NODES and m_local == 10
    x, y = next(batches)
    assert x.shape == (common.N_NODES, common.BATCH_PER_NODE, 784)
    grads, loss = grad_fn(stack, (torch.as_tensor(x), torch.as_tensor(y)))
    assert set(grads) == set(stack) and float(loss) > 0
    assert 0.0 <= float(eval_fn(stack)) <= 1.0
