"""PyTorch port: ``run_decentralized`` against the JAX trainer.

Both trainers run the same configuration from the same seed (the
quickstart: 8 nodes on a ring, MLR 64 -> 10; and the paper's 50-node
ER(0.35) MLR 784 -> 10 test bed with the qsgdf:4 wire): losses agree at
1e-4 relative, eval accuracies to 2 of 1000 test examples, and the
communicated elements, wire bits and epsilons are exactly equal.
Without a GPU the entry points raise unless given ``device="cpu"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sdm_dsgd as jsdm  # noqa: E402
from repro.core.privacy import PrivacyParams as JPrivacy  # noqa: E402
from repro.data import (classification_dataset,  # noqa: E402
                        node_partitioned_batches)
from repro.models import vision_small as jvs  # noqa: E402
from repro.train.trainer import run_decentralized as jrun  # noqa: E402
from repro_torch import prng, tree as tree_mod  # noqa: E402
from repro_torch.convert import tree_from_jax  # noqa: E402
from repro_torch.core import baselines as tbase, sdm_dsgd as tsdm  # noqa: E402
from repro_torch.core.privacy import PrivacyParams as TPrivacy  # noqa: E402
from repro_torch.models import vision_small as tvs  # noqa: E402
from repro_torch.train.trainer import run_decentralized as trun  # noqa: E402



def _quickstart_inputs(pkg, n=8, feat=64, n_train=4000):
    classes = 10
    (x_tr, y_tr), (x_te, y_te) = classification_dataset(feat, classes,
                                                        n_train, 1000, seed=0)
    m = n_train // n
    kw = dict(G=5.0, m=m, tau=16 / m, p=0.2, sigma=1.0)
    if pkg == "jax":
        p0 = jvs.mlr_init(jax.random.PRNGKey(0), feat, classes)
        stack = jax.tree.map(lambda p: jnp.broadcast_to(
            p[None], (n,) + p.shape), p0)
        return dict(
            params_stack=stack,
            grad_fn=jvs.make_stacked_grad_fn(jvs.mlr_apply),
            eval_fn=jvs.make_eval_fn(jvs.mlr_apply, jnp.asarray(x_te),
                                     jnp.asarray(y_te)),
            batches=node_partitioned_batches(x_tr, y_tr, n, 16, seed=0),
            privacy=JPrivacy(**kw))
    p0 = tvs.mlr_init(prng.PRNGKey(0), feat, classes)
    stack = tree_mod.tree_map(lambda p: p[None].expand(
        (n,) + tuple(p.shape)).clone(), p0)
    return dict(
        params_stack=stack,
        grad_fn=tvs.make_stacked_grad_fn(tvs.mlr_apply),
        eval_fn=tvs.make_eval_fn(tvs.mlr_apply, torch.from_numpy(x_te),
                                 torch.from_numpy(y_te)),
        batches=node_partitioned_batches(x_tr, y_tr, n, 16, seed=0),
        privacy=TPrivacy(**kw))


TRAJECTORIES = {
    # the quickstart: 8 nodes on a ring, MLR 64 -> 10, bernoulli wire
    "quickstart": (dict(n=8, feat=64, n_train=4000), "ring", None, 10),
    "quickstart_qsgdf4": (dict(n=8, feat=64, n_train=4000), "ring",
                          "qsgdf:4", 10),
    # the chip smoke test's MLR run: the paper's 50-node ER(0.35) test bed
    "testbed_qsgdf4": (dict(n=50, feat=784, n_train=10_000), "er:0.35",
                       "qsgdf:4", 4),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_run_decentralized_matches_jax_trajectory(case):
    shape, topo, compressor, steps = TRAJECTORIES[case]
    common = dict(topo=topo, algorithm="sdm_dsgd", steps=steps, seed=0,
                  eps_target=1.0, eval_every=2)
    cfg = dict(p=0.2, theta=0.25, gamma=0.05, sigma=1.0, clip_c=5.0,
               compressor=compressor)
    jres = jrun(sdm_cfg=jsdm.SDMConfig(**cfg), **common,
                **_quickstart_inputs("jax", **shape))
    tres = trun(sdm_cfg=tsdm.SDMConfig(**cfg), device="cpu", **common,
                **_quickstart_inputs("torch", **shape))
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert tres.comm_elements == jres.comm_elements
    assert tres.comm_bits == jres.comm_bits
    assert tres.epsilons == jres.epsilons
    np.testing.assert_allclose(tres.eval_accuracy, jres.eval_accuracy,
                               atol=2e-3)   # at most 2 of 1000 flip
    assert len(tres.step_s) == steps and tres.state.step == steps


def test_run_decentralized_checkpoints(tmp_path):
    inputs = _quickstart_inputs("torch")
    inputs.pop("privacy")
    res = trun(topo="ring", algorithm="dsgd",
               sdm_cfg=tbase.DSGDConfig(gamma=0.05), steps=2, device="cpu",
               checkpoint_dir=str(tmp_path), checkpoint_every=2, **inputs)
    from repro_torch.checkpoint import latest_step, load_flat
    assert latest_step(str(tmp_path)) == 2
    flat = load_flat(str(tmp_path / "step_00000002.npz"))
    assert sorted(flat) == ["step", "x/b", "x/w"]
    np.testing.assert_array_equal(flat["x/w"], res.state.x["w"].numpy())


def test_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    inputs = _quickstart_inputs("torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun(topo="ring", algorithm="sdm-dsgd", sdm_cfg=tsdm.SDMConfig(),
             steps=1, **inputs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tree_from_jax({"w": np.zeros(3, np.float32)})
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
