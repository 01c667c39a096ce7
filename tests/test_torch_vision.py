"""PyTorch port: the paper's vision models against the JAX package.

Logits and per-node gradients of MLR, CNN and ResNet-20 on the same
parameters and inputs, at f32 tolerance: the two libraries sum in
different orders, and ResNet-20 stacks 19 convolutions and 19 group
norms (1e-6 for MLR, 2e-5 for the CNN, 2e-4 for ResNet-20; gradients
10x that). Also: the port's initializers draw JAX's keys, and a stride-2
SAME convolution pads (0, 1) as XLA does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import vision_small as jvs  # noqa: E402
from repro_torch import prng, tree as tree_mod  # noqa: E402
from repro_torch.models import vision_small as tvs  # noqa: E402
from test_torch_sdm import _assert_tree_close, _to_torch  # noqa: E402


# --------------------------------------------------------------------------
# vision_small
# --------------------------------------------------------------------------

MODELS = {
    "mlr": (lambda k: jvs.mlr_init(k, 48, 10), jvs.mlr_apply, tvs.mlr_apply,
            48, 1e-6),
    "cnn": (lambda k: jvs.cnn_init(k, (12, 12, 3)),
            lambda p, x: jvs.cnn_apply(p, x, (12, 12, 3)),
            lambda p, x: tvs.cnn_apply(p, x, (12, 12, 3)), 432, 2e-5),
    "resnet20": (jvs.resnet20_init, jvs.resnet20_apply, tvs.resnet20_apply,
                 3072, 2e-4),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vision_apply_and_grads_match(name):
    init, japply, tapply, feat, tol = MODELS[name]
    n, b = 2, 3
    rng = np.random.default_rng(0)
    p0 = init(jax.random.PRNGKey(1))
    # distinct per-node parameters (a perturbed copy each)
    stack = jax.tree.map(lambda v: jnp.stack(
        [v + 0.05 * i * jnp.asarray(rng.normal(size=v.shape), v.dtype)
         for i in range(n)]), p0)
    x = rng.normal(size=(n, b, feat)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, b)).astype(np.int32)
    jl = np.asarray(japply(jax.tree.map(lambda v: v[0], stack),
                           jnp.asarray(x[0])))
    tstack = _to_torch(stack)
    tl = tapply(tree_mod.tree_map(lambda v: v[0], tstack),
                torch.from_numpy(x[0])).detach().numpy()
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)
    jg, jloss = jvs.make_stacked_grad_fn(japply)(stack, (jnp.asarray(x),
                                                         jnp.asarray(y)))
    tg, tloss = tvs.make_stacked_grad_fn(tapply)(
        tstack, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol)
    _assert_tree_close(jg, tg, rtol=10 * tol, atol=10 * tol, what=name)


def test_resnet20_init_and_stride2_padding():
    """The port's init draws JAX's keys (erfinv within a few ulp), and a
    stride-2 SAME conv pads (0, 1) as XLA does."""
    jp = jvs.resnet20_init(jax.random.PRNGKey(0))
    tp = tvs.resnet20_init(prng.PRNGKey(0))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tvs._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
