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
from test_torch_kernels_cuda import PAGED_CASES, paged_case, split_cases

from repro.kernels.flash_attn.decode import paged_attention as jax_paged
from repro_torch import configs
from repro_torch.kernels.flash_attn import decode
from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                   paged_attention_ref,
                                                   split_plan)

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


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device the port does not take (``meta``
    is now the dry-run's: it returns an empty output and charges the
    kernel's cost, ``tests/test_torch_dryrun.py``)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_paged_attention_rejects_other_devices_and_bad_window():
    q, k, v, tbl, lens = paged_case(2, **PAGED_CASES["smoke"])
    t = [torch.from_numpy(a) for a in (q, k, v, tbl, lens)]
    with pytest.raises(ValueError):
        paged_attention(*[a.as_subclass(_Elsewhere) for a in t])
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


# ---- the decode kernel's split-K plan (host side, shapes only) ------------

PLAN_SHAPES = [(b, kvh, n) for b in (1, 3, 8, 33, 66, 300)
               for kvh in (1, 4, 8) for n in (1, 2, 5, 16, 66, 67, 1000)]


@pytest.mark.parametrize("b,kvh,n_blocks", PLAN_SHAPES)
def test_split_plan_covers_the_table_exactly(b, kvh, n_blocks):
    plan = split_plan(b, kvh, 2, 256, n_blocks)
    p, n = plan.pages_per_split, plan.n_splits
    assert p >= 1 and n >= 1
    # every page in exactly one split; only the last may be short
    assert (n - 1) * p < n_blocks <= n * p
    # enough blocks for the card, unless the table runs out of pages
    assert b * kvh * n >= min(decode.MIN_BLOCKS, b * kvh * n_blocks)
    if b * kvh >= decode.MIN_BLOCKS:
        assert n == 1
    else:   # whole block steps: P a power of two, the largest that fits
        assert p & (p - 1) == 0
        assert 2 * p > n_blocks or b * kvh * -(-n_blocks // (2 * p)) \
            < decode.MIN_BLOCKS
    assert plan.scratch_shape == (None if n == 1 else (b, kvh * 2, n, 258))


@pytest.mark.parametrize("case", ["phi3", "chatglm3", "qwen1_5",
                                  "granite_moe", "qwen3_moe", "jamba"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_split_plan_covers_the_table_at_the_dense_layouts(case, b):
    """The dense, MoE and hybrid configs' head layouts, at the kernel
    tests' table and at the serving tables of phases 19-20 (66 blocks of
    16: max_seq 1056; 17: max_seq 264)."""
    shape = PAGED_CASES[case]
    kvh, group, dh = shape["kvh"], shape["group"], shape["dh"]
    for n_blocks in (1, shape["n_blocks"], 17, 66, 67, 1000):
        plan = split_plan(b, kvh, group, dh, n_blocks)
        p, n = plan.pages_per_split, plan.n_splits
        assert (n - 1) * p < n_blocks <= n * p
        assert b * kvh * n >= min(decode.MIN_BLOCKS, b * kvh * n_blocks)
        assert plan.scratch_shape == (
            None if n == 1 else (b, kvh * group, n, dh + 2))


def test_split_plan_reads_no_device_value():
    """(P, S) follow from (b, kvh, n_blocks) alone: the head layout only
    shapes the scratch, and the wrapper takes the plan from shapes and
    never reads a tensor back (no .item(), .tolist(), .cpu(), sync)."""
    import inspect
    base = split_plan(8, 4, 2, 256, 66)
    for group, dh in ((1, 32), (4, 128), (8, 64)):
        other = split_plan(8, 4, group, dh, 66)
        assert other[:2] == base[:2]
        assert other.scratch_shape == (8, 4 * group, base.n_splits, dh + 2)
    src = inspect.getsource(decode._paged_decode_cuda)
    assert "split_plan(b, kvh, h // kvh, dh, n_blocks)" in src
    for word in (".item(", ".tolist(", ".cpu(", "synchronize", "numpy("):
        assert word not in src
    with pytest.raises(ValueError):
        split_plan(0, 4, 2, 256, 66)


def test_split_plan_at_the_serving_shape():
    """gemma2-2b serving: 8 rows, 4 KV heads, 66 blocks of 16 tokens."""
    plan = split_plan(8, 4, 2, 256, 66)
    assert 8 * 4 * plan.n_splits >= 2 * 132
    assert plan.pages_per_split == 8 and plan.n_splits == 9
    n_bytes = 4 * int(np.prod(plan.scratch_shape))
    assert n_bytes == 594_432                   # 0.59 MB of f32 partials


def _split_merge(q, k, v, tbl, lens, plan, *, window, softcap):
    """The kernel's decomposition in plain torch (f32): one partial
    (m, l, acc) per split over its own visible tokens, an empty one (m
    -1e30, l 0, acc 0) where it sees none, merged by max-rescaling."""
    b, h, dh = q.shape
    _, page, kvh, _ = k.shape
    group = h // kvh
    kk = k[tbl.long()].reshape(b, -1, kvh, dh)
    vv = v[tbl.long()].reshape(b, -1, kvh, dh)
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(b, kvh, group, dh),
                     kk) / np.sqrt(dh)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(kk.shape[1])
    seq = lens.long()[:, None]
    vis = (pos < seq) & (pos >= (seq - window if window else 0))
    span = plan.pages_per_split * page
    ms, ls, accs = [], [], []
    for i in range(plan.n_splits):
        mask = (vis & (pos >= i * span) & (pos < (i + 1) * span))[:, None,
                                                                 None]
        m = torch.where(mask, s, -1e30).amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, vv))
    m_all = torch.stack(ms).amax(0)
    w = [torch.exp(m - m_all) for m in ms]
    num = sum(wi * a for wi, a in zip(w, accs))
    den = sum(wi * li for wi, li in zip(w, ls))
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(b, h, dh)


@pytest.mark.parametrize("case", split_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_split_k_decomposition_matches_plain(case, softcap):
    """The split-K partials and their merge give the plain attention on
    the kernel's test cases: window edges inside a split, empty splits,
    seq_len 0 rows."""
    _, shape, lens, window = case
    q, k, v, tbl, sl = (torch.from_numpy(a) for a in paged_case(
        5, seq_lens=lens, **shape))
    plan = split_plan(shape["b"], shape["kvh"], shape["group"],
                      shape["dh"], shape["n_blocks"])
    got = _split_merge(q, k, v, tbl, sl, plan, window=window,
                       softcap=softcap)
    want = paged_attention_ref(q, k, v, tbl, sl, window=window,
                               softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert not got.numpy()[sl.numpy() == 0].any()
