"""PyTorch port: paged flash decode against the JAX package.

The port's ``paged_attention`` on CPU tensors runs its plain version;
it is held against the JAX ``paged_attention`` in both of its modes
(the Pallas kernel in interpret mode, and the jnp reference) on the same
numpy inputs, at the JAX package's own tolerance (f32, atol 2e-5). The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import PAGED_CASES, paged_case

from repro.kernels.flash_attn.decode import paged_attention as jax_paged
from repro_torch import configs
from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                   paged_attention_ref)

torch.set_num_threads(2)

ATOL = 2e-5   # tests/test_serving_engine.py's flash-vs-oracle tolerance


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 5.0), (6, 50.0)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_paged_attention_matches_jax(case, window, softcap, use_kernel):
    q, k, v, tbl, lens = paged_case(0, **PAGED_CASES[case])
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(lens), window=window, softcap=softcap,
        use_kernel=use_kernel, interpret=True))
    launches = paged_attention.launches
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(tbl),
                          torch.from_numpy(lens), window=window,
                          softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # empty rows contribute exactly nothing
    assert not got.numpy()[lens == 0].any()
    # CPU tensors never reach the kernel
    assert paged_attention.launches == launches


def test_paged_attention_bf16_plain_computes_in_f32():
    """bf16 inputs: the plain version upcasts, computes in f32 (as the
    kernel does) and rounds only its output to bf16."""
    q, k, v, tbl, lens = paged_case(1, **PAGED_CASES["gemma2"])
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    tb, ln = torch.from_numpy(tbl), torch.from_numpy(lens)
    got = paged_attention(*bf, tb, ln, window=32, softcap=50.0)
    want = paged_attention_ref(*[a.float() for a in bf], tb, ln, window=32,
                               softcap=50.0).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_paged_attention_rejects_other_devices_and_bad_window():
    q, k, v, tbl, lens = paged_case(2, **PAGED_CASES["smoke"])
    t = [torch.from_numpy(a) for a in (q, k, v, tbl, lens)]
    with pytest.raises(ValueError):
        paged_attention(*[a.to("meta") for a in t])
    with pytest.raises(ValueError):
        paged_attention(*t, window=0)


def test_entry_points_refuse_cpu_fallback():
    """Without CUDA, entry points called without ``device=`` raise
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works here")
    from repro_torch.models import transformer
    from repro_torch.serving import (PagedKVCache, ServingEngine,
                                     StaticServingEngine)
    cfg = configs.get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_params(cfg)
    params = transformer.init_params(cfg, device="cpu")
    for make in (lambda: ServingEngine(cfg, params),
                 lambda: StaticServingEngine(cfg, params),
                 lambda: PagedKVCache(cfg, max_batch=2, max_seq=16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
