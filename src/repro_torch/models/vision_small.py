"""The paper's own experimental models (§5): MLR, small CNN, ResNet-20.

Port of ``repro.models.vision_small``. Parameters keep the JAX layout
(flat dicts; conv weights HWIO) so a JAX tree converts leaf for leaf
(``convert.tree_from_jax``); inputs arrive flat (784 / 3072) as in JAX.
The convolutions run NCHW with OIHW weights, permuted at the call.

``lax.conv_general_dilated(..., "SAME")`` pads asymmetrically when the
total padding is odd (stride 2 on an even size pads (0, 1)), which
``conv2d(padding=1)`` does not reproduce; ``_conv`` pads explicitly
with XLA's SAME rule. Group norm uses the population variance, as
``jnp.var`` does. The CNN flattens in NHWC order before its dense layer,
so its ``fc`` rows mean what they mean in JAX.

Gradients: ``make_stacked_grad_fn`` is ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the node axis, where JAX vmaps
``value_and_grad``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng, tree as tree_mod

__all__ = ["mlr_init", "mlr_apply", "cnn_init", "cnn_apply", "resnet20_init",
           "resnet20_apply", "make_stacked_grad_fn", "make_eval_fn"]

PyTree = Any


# --------------------------------------------------------------------------
# MLR
# --------------------------------------------------------------------------

def mlr_init(key, n_features: int = 784, n_classes: int = 10) -> PyTree:
    dev = prng.key_data(key).device
    return {"w": torch.zeros((n_features, n_classes), device=dev),
            "b": torch.zeros((n_classes,), device=dev)}


def mlr_apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


# --------------------------------------------------------------------------
# Convolution helpers (NCHW activations, HWIO weights in the tree)
# --------------------------------------------------------------------------

def _conv_init(key, kh, kw, cin, cout):
    std = 1.0 / math.sqrt(kh * kw * cin)
    return std * prng.normal(key, (kh, kw, cin, cout))


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding: (lo, hi), the odd unit on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    ph = _same_pad(x.shape[-2], kh, stride)
    pw = _same_pad(x.shape[-1], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _nchw(x_flat: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    return x_flat.reshape(-1, h, w, c).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# CNN (paper's MNIST/CIFAR model)
# --------------------------------------------------------------------------

def cnn_init(key, image_hw: Tuple[int, int, int]) -> PyTree:
    h, w, c = image_hw
    k1, k2, k3 = prng.split(key, 3)
    flat = (h // 4) * (w // 4) * 16
    dev = k1.device
    return {
        "conv1": _conv_init(k1, 3, 3, c, 16),
        "b1": torch.zeros((16,), device=dev),
        "conv2": _conv_init(k2, 3, 3, 16, 16),
        "b2": torch.zeros((16,), device=dev),
        "fc": (1.0 / math.sqrt(flat)) * prng.normal(k3, (flat, 10)),
        "fc_b": torch.zeros((10,), device=dev),
    }


def cnn_apply(params: PyTree, x_flat: torch.Tensor,
              image_hw: Tuple[int, int, int]) -> torch.Tensor:
    h, w, c = image_hw
    x = _nchw(x_flat, h, w, c)
    b1 = params["b1"].reshape(-1, 1, 1)
    b2 = params["b2"].reshape(-1, 1, 1)
    x = _maxpool2(torch.relu(_conv(x, params["conv1"]) + b1))
    x = _maxpool2(torch.relu(_conv(x, params["conv2"]) + b2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)     # NHWC flatten
    return x @ params["fc"] + params["fc_b"]


# --------------------------------------------------------------------------
# ResNet-20 (CIFAR-10), group-norm variant
# --------------------------------------------------------------------------

def _gn(x, gamma, beta, groups=8, eps=1e-5):
    n, c, h, w = x.shape
    g = x.reshape(n, groups, c // groups, h, w)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = g.var(dim=(2, 3, 4), keepdim=True, correction=0)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(n, c, h, w) * gamma.reshape(-1, 1, 1) \
        + beta.reshape(-1, 1, 1)


def resnet20_init(key) -> PyTree:
    keys = iter(prng.split(key, 64))
    dev = prng.key_data(key).device
    params: Dict[str, Any] = {
        "stem": _conv_init(next(keys), 3, 3, 3, 16),
        "stem_g": torch.ones((16,), device=dev),
        "stem_b": torch.zeros((16,), device=dev),
    }
    cin = 16
    for stage, cout in enumerate((16, 32, 64)):
        for block in range(3):
            pre = f"s{stage}b{block}"
            params[f"{pre}_c1"] = _conv_init(next(keys), 3, 3, cin, cout)
            params[f"{pre}_g1"] = torch.ones((cout,), device=dev)
            params[f"{pre}_b1"] = torch.zeros((cout,), device=dev)
            params[f"{pre}_c2"] = _conv_init(next(keys), 3, 3, cout, cout)
            params[f"{pre}_g2"] = torch.ones((cout,), device=dev)
            params[f"{pre}_b2"] = torch.zeros((cout,), device=dev)
            if cin != cout:
                params[f"{pre}_proj"] = _conv_init(next(keys), 1, 1, cin,
                                                   cout)
            cin = cout
    params["fc"] = (1.0 / 8.0) * prng.normal(next(keys), (64, 10))
    params["fc_b"] = torch.zeros((10,), device=dev)
    return params


def resnet20_apply(params: PyTree, x_flat: torch.Tensor) -> torch.Tensor:
    x = _nchw(x_flat, 32, 32, 3)
    x = torch.relu(_gn(_conv(x, params["stem"]), params["stem_g"],
                       params["stem_b"]))
    for stage, cout in enumerate((16, 32, 64)):
        for block in range(3):
            pre = f"s{stage}b{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            h = _conv(x, params[f"{pre}_c1"], stride)
            h = torch.relu(_gn(h, params[f"{pre}_g1"], params[f"{pre}_b1"]))
            h = _conv(h, params[f"{pre}_c2"])
            h = _gn(h, params[f"{pre}_g2"], params[f"{pre}_b2"])
            sc = x
            if f"{pre}_proj" in params:
                sc = _conv(x, params[f"{pre}_proj"], stride)
            x = torch.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"] + params["fc_b"]


# --------------------------------------------------------------------------
# Shared loss/grad helpers for the decentralized trainers
# --------------------------------------------------------------------------

def make_stacked_grad_fn(apply_fn):
    """(params_stack, (x_stack, y_stack)) -> (grads_stack, mean_loss)."""

    def node_loss(params, x, y):
        logits = apply_fn(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, y.long()[:, None]).mean()

    per_node = torch.func.vmap(torch.func.grad_and_value(node_loss))

    def grad_fn(params_stack, batch_stack):
        x, y = batch_stack
        grads, losses = per_node(params_stack, x, y)
        return grads, losses.mean()

    return grad_fn


def make_eval_fn(apply_fn, x_test: torch.Tensor, y_test: torch.Tensor):
    """params_stack -> accuracy of the node-mean parameters (a 0-d tensor)."""

    @torch.no_grad()
    def eval_fn(params_stack):
        params = tree_mod.tree_map(lambda p: p.mean(dim=0), params_stack)
        logits = apply_fn(params, x_test)
        return (torch.argmax(logits, -1) == y_test).float().mean()

    return eval_fn
