"""PyTorch port: LM training through the per-node executor, against JAX.

- ``transformer.forward`` + ``lm_loss`` and their gradients equal the
  JAX package's at gemma2-2b's smoke config (parameters carried over by
  ``convert.params_from_jax``), with and without ``remat``.
- ``train.steps.make_distributed_train``: 3 steps of SDM-DSGD
  (fixedk:8 wire, sigma > 0, clipping) on 4 nodes against the JAX
  package's shard_map train step on a faked 4-device mesh, run live in a
  subprocess this test starts (``XLA_FLAGS`` before jax imports), from
  the same initial parameters and token batches. The transport's
  counters equal ``wire_count``.
- ``python -m repro_torch.launch.train --smoke --device cpu`` runs and
  prints finite losses; without ``--device`` it targets CUDA and raises
  here; its checkpoint is read back by the serving ingest.
"""
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
N_NODES, STEPS, BATCH, SEQ = 4, 3, 8, 32
SDM_KW = dict(p=0.2, theta=0.5, gamma=1e-2, sigma=0.1, clip_c=1.0,
              compressor="fixedk:8")


def _flat(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _jax_main(out_path: str) -> None:
    """The JAX package's train step on 4 faked CPU devices."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={N_NODES}"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.core.sdm_dsgd import SDMConfig
    from repro.data import TokenStream
    from repro.launch.mesh import make_mesh_by_name
    from repro.train import steps

    cfg = configs.get_smoke_config(ARCH)
    mesh = make_mesh_by_name(str(N_NODES))
    tc = steps.DistributedTrainConfig(model=cfg, sdm=SDMConfig(**SDM_KW),
                                      topology="ring", method="sdm-dsgd",
                                      param_dtype=jnp.float32)
    state = steps.init_distributed_state(tc, mesh, jax.random.PRNGKey(0))
    out = {f"init/{k}": v[0] for k, v in _flat(state.x).items()}
    step_fn = jax.jit(steps.make_distributed_train(tc, mesh))
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=BATCH,
                         seq_len=SEQ, seed=0)
    losses = []
    for t in range(STEPS):
        tokens, labels = stream.batch_at(t)
        state, loss = step_fn(state, jnp.asarray(tokens), jnp.asarray(labels))
        losses.append(float(loss))
    out["losses"] = np.asarray(losses)
    out.update({f"x/{k}": v for k, v in _flat(state.x).items()})
    out.update({f"s/{i}": np.asarray(v) for i, v in enumerate(state.s)})
    np.savez(out_path, **out)


torch = pytest.importorskip("torch")

from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import (method as method_mod, sdm_dsgd,  # noqa: E402
                              transport as tr, wire_count)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(remat):
    jax = pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as jtf

    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), remat=remat)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), remat=remat)
    jparams = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)

    def jloss(p):
        logits, aux = jtf.forward(p, jcfg, jnp.asarray(tokens))
        return jtf.lm_loss(logits, jnp.asarray(labels), jcfg.vocab_size,
                           aux)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    params = params_from_jax(_flat(jparams), cfg, device="cpu")
    leaves, struct = tree_mod.flatten(params)
    mine = [v.requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      torch.from_numpy(tokens))
    assert logits.shape == (2, 24, cfg.padded_vocab)
    loss = transformer.lm_loss(logits, torch.from_numpy(labels),
                               cfg.vocab_size, aux)
    grads = torch.autograd.grad(loss, mine)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=2e-6)
    want = _flat(jg)
    got = tree_mod.flatten_with_paths(tree_mod.unflatten(struct, grads))
    assert sorted(want) == sorted(got)
    for k in want:
        scale = max(float(np.max(np.abs(want[k]))), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_lm_loss_masks_the_padded_vocab():
    import dataclasses

    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), vocab_size=500)
    assert cfg.padded_vocab == 512
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 5, cfg.padded_vocab, generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    loud = logits.clone()
    loud[..., cfg.vocab_size:] = 1e4          # the pad tail never counts
    base = transformer.lm_loss(logits, labels, cfg.vocab_size)
    assert torch.equal(base, transformer.lm_loss(loud, labels,
                                                 cfg.vocab_size))
    real = torch.nn.functional.cross_entropy(
        logits[..., :cfg.vocab_size].reshape(-1, cfg.vocab_size),
        labels.reshape(-1))
    torch.testing.assert_close(base, real, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_train") / "train.npz"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--jax",
         str(out)], capture_output=True, text=True, timeout=900,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _tc():
    return steps.DistributedTrainConfig(
        model=configs.get_smoke_config(ARCH),
        sdm=sdm_dsgd.SDMConfig(**SDM_KW), topology="ring",
        method="sdm-dsgd", param_dtype=torch.float32)


def test_distributed_train_matches_jax_train_step(jax_train):
    tc = _tc()
    init = {k[len("init/"):]: v for k, v in jax_train.items()
            if k.startswith("init/")}
    params = params_from_jax(init, tc.model, device="cpu")
    transport = tr.StackTransport(N_NODES, "cpu")
    state = steps.init_distributed_state(tc, transport, params=params)
    run = train_mod.train(tc, transport, steps=STEPS, global_batch=BATCH,
                          seq_len=SEQ, state=state)
    np.testing.assert_allclose(run.losses, jax_train["losses"], rtol=1e-5)
    got = tree_mod.flatten_with_paths(run.state.x)
    want = {k[2:]: v for k, v in jax_train.items() if k.startswith("x/")}
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.max(np.abs(want[k]))), 1.0)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    (s_plane,) = run.state.s
    np.testing.assert_allclose(s_plane.numpy(), jax_train["s/0"], rtol=0,
                               atol=1e-5 * max(float(np.max(np.abs(
                                   jax_train["s/0"]))), 1.0))

    # the sends and bytes of the run, by the exact accounting
    meth, cfg = tc.resolved()
    seq = steps.gossip_schedule(tc, N_NODES)
    mode = wire_count.mode_of(meth.name, cfg)
    assert transport.permutes == STEPS * wire_count.expected_permutes(
        meth.name, mode, seq) == STEPS * 2
    assert transport.bytes_sent == wire_count.expected_bytes_sent(
        meth, params, cfg, seq, STEPS)


def test_launcher_cli_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--mesh", "4", "--steps", "2",
         "--compressor", "fixedk:8", "--checkpoint-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "nodes=4" in out.stdout and "device=cpu" in out.stdout
    losses = [float(v) for v in re.findall(r"^step +\d+ loss (\S+)",
                                           out.stdout, re.MULTILINE)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)

    # the trainer checkpoint is the JAX package's format: serving ingest
    # finds the 4 node replicas under ``x`` and averages them
    from repro_torch.serving.ingest import ingest_checkpoint

    params, report = ingest_checkpoint(str(tmp_path), configs
                                       .get_smoke_config(ARCH), device="cpu")
    assert report.prefix == "x" and report.n_nodes == 4
    assert all(torch.isfinite(v).all() for v in tree_mod.leaves(params))


def test_launcher_cli_runs_gradient_push_on_the_cpu():
    """--method gradient-push on a directed graph through the registry:
    compressed (fixedk:8, payload + mass) and full-state push-sum."""
    for extra in (["--compressor", "fixedk:8", "--topology", "dring"],
                  ["--topology", "der:0.5"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
             "--smoke", "--device", "cpu", "--mesh", "4", "--steps", "2",
             "--method", "gradient-push", *extra],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert out.returncode == 0, out.stderr[-3000:]
        assert "method=gradient-push" in out.stdout
        losses = [float(v) for v in re.findall(r"^step +\d+ loss (\S+)",
                                               out.stdout, re.MULTILINE)]
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses)


def test_launcher_one_process_per_node_on_gloo():
    """--init-method runs one node per process (gloo on the CPU): the same
    losses as the run with both nodes on one StackTransport."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
            "--smoke", "--device", "cpu", "--mesh", "2", "--steps", "2",
            "--seq-len", "16", "--compressor", "fixedk:8", "--sigma", "0.5",
            "--clip-c", "1.0"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        args + ["--init-method", f"tcp://127.0.0.1:{port}", "--rank", str(r),
                "--world-size", "2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    stack = subprocess.run(args, capture_output=True, text=True, timeout=300,
                           env=env)
    assert stack.returncode == 0, stack.stderr[-3000:]

    def losses(text):
        return re.findall(r"^step +\d+ loss (\S+)", text, re.MULTILINE)

    assert len(losses(stack.stdout)) == 2
    assert losses(outs[0]) == losses(outs[1]) == losses(stack.stdout)


def test_launcher_targets_cuda_by_default_and_refuses_what_is_not_ported():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base = ["--arch", ARCH, "--smoke", "--steps", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(base)
    # a model axis across the cards of a pod, and tensor parallelism
    # outside the dense family, are not ported
    with pytest.raises(ValueError, match="TPU pod mesh.*ROADMAP"):
        train_mod.main(base + ["--device", "cpu", "--mesh", "16x16"])
    with pytest.raises(NotImplementedError, match="dense decoder family"):
        train_mod.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                        "--steps", "1", "--device", "cpu", "--mesh", "2x2"])


@pytest.mark.parametrize("name,nodes", [("4", 4), ("4x1", 4), ("2x3x1", 6),
                                        ("1", 1)])
def test_mesh_specs_name_node_counts(name, nodes):
    assert mesh_mod.parse_mesh(name).n_nodes == nodes


@pytest.mark.parametrize("name", ["2x2", "single_pod", "multi_pod", "4x"])
def test_mesh_specs_refuse_tensor_parallel_and_pods(name):
    """The pod meshes and malformed names raise. A model axis on one
    device runs the dense family only: ``2x2`` parses (2 nodes, 2
    shards) and tensor parallelism of an MoE model raises."""
    if name != "2x2":
        with pytest.raises(ValueError):
            mesh_mod.parse_mesh(name)
        return
    mesh = mesh_mod.parse_mesh(name)
    assert (mesh.n_nodes, mesh.model) == (2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.check_tensor_parallel(
            configs.get_smoke_config("granite-moe-1b-a400m"))


def test_registry_faces_are_callable():
    for name in ("sdm-dsgd", "sdm-dsgd-fused", "dc-dsgd", "dsgd",
                 "allreduce"):
        meth = method_mod.get(name)
        assert callable(meth.make_distributed) and callable(meth.init_stacked)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main(sys.argv[2])
