"""PyTorch port: the CUDA kernels against their plain versions, on the card.

The paged decode and prefill flash kernels are held at f32/bf16
tolerances; the qsgd_pack and fixedk_gather_pack kernels must equal their
plain versions bit for bit (``torch.equal``), the fused SDM update too or,
where a transcendental differs in its last bit, within 1e-6. The ring
gossip helpers launch fixedk_gather_pack and equal themselves with the
gather routed to its plain version; the overlapped executors, with each
exchange in flight on the transport's side stream, equal the run that
waits on each exchange inside its step, also when memory is freed and
reused between the steps; exchanges that are not deferred never touch
the side stream. ``restore_checkpoint`` onto the card equals the host
restore.

Imports no jax (the card's machine has none). Every test here is marked
``cuda`` and skips without a GPU; run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``paged_case`` / ``PAGED_CASES`` are shared with ``test_torch_decode.py``.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                   paged_attention_ref,
                                                   split_plan)


def paged_case(seed, *, b, kvh, group, dh, page, n_blocks, seq_lens):
    """Random q (b, kvh*group, dh), page pools (b*n_blocks + 1, page,
    kvh, dh) and a disjoint block table like the real allocator's; short
    rows' trailing blocks point at the trash page 0."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_blocks
    q = rng.normal(size=(b, kvh * group, dh)).astype(np.float32)
    k = rng.normal(size=(n_pages + 1, page, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(n_pages + 1, page, kvh, dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages + 1))
    seq_lens = np.asarray(seq_lens, np.int32)
    tbl = np.zeros((b, n_blocks), np.int32)
    nxt = 0
    for i in range(b):
        need = -(-max(int(seq_lens[i]), 1) // page)
        tbl[i, :need] = perm[nxt:nxt + need]
        nxt += need
    return q, k, v, tbl, seq_lens


PAGED_CASES = {
    # smoke width: 3-way GQA, dh 32, page 4, incl. an empty row
    "smoke": dict(b=5, kvh=2, group=3, dh=32, page=4, n_blocks=4,
                  seq_lens=[0, 1, 7, 16, 10]),
    # gemma2-2b decode head layout: kvh 4, group 2, dh 256, page 16
    "gemma2": dict(b=4, kvh=4, group=2, dh=256, page=16, n_blocks=5,
                   seq_lens=[0, 16, 17, 80]),
    # phi3-medium-14b: 40 query heads over 10 KV heads, dh 128
    "phi3": dict(b=3, kvh=10, group=4, dh=128, page=16, n_blocks=3,
                 seq_lens=[0, 17, 40]),
    # chatglm3-6b: 32 query heads over 2 KV heads; group 16 > the kernel's
    # 8 query heads a block, so each KV head spreads over two blocks
    "chatglm3": dict(b=3, kvh=2, group=16, dh=128, page=16, n_blocks=3,
                     seq_lens=[5, 0, 48]),
    # qwen1.5-32b: MHA, 40 KV heads, one query head each
    "qwen1_5": dict(b=2, kvh=40, group=1, dh=128, page=16, n_blocks=2,
                    seq_lens=[16, 30]),
    # granite-moe-1b-a400m: 16 query heads over 8 KV heads, dh 64
    "granite_moe": dict(b=3, kvh=8, group=2, dh=64, page=16, n_blocks=3,
                        seq_lens=[33, 0, 16]),
    # qwen3-moe-30b-a3b: 32 query heads over 4 KV heads (a full block of
    # 8 a KV head), dh 128
    "qwen3_moe": dict(b=3, kvh=4, group=8, dh=128, page=16, n_blocks=3,
                      seq_lens=[1, 48, 0]),
    # jamba-v0.1-52b: 32 query heads over 8 KV heads, dh 128, no RoPE
    "jamba": dict(b=2, kvh=8, group=4, dh=128, page=16, n_blocks=3,
                  seq_lens=[40, 17]),
    # whisper-large-v3's decoder: MHA, 20 KV heads (not a power of two),
    # one query head each, dh 64
    "whisper": dict(b=3, kvh=20, group=1, dh=64, page=16, n_blocks=3,
                    seq_lens=[0, 17, 48]),
    # llama-3.2-vision-11b's self-attention: jamba's layout (32 query
    # heads over 8 KV heads, dh 128) with RoPE
    "llama_vision": dict(b=3, kvh=8, group=4, dh=128, page=16, n_blocks=3,
                         seq_lens=[33, 1, 0]),
}

# f32: the JAX package's flash-vs-oracle tolerance. bf16: both sides
# compute in f32 from the same bf16 inputs and round only the output, so
# they differ by at most one bf16 ulp of |out| < 4 (2^-6 = 1.6e-2).
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 50.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(case, window, softcap, dtype):
    dev = _cuda()
    q, k, v, tbl, lens = paged_case(3, **PAGED_CASES[case])
    qkv = [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]
    tl = [torch.from_numpy(a).to(dev) for a in (tbl, lens)]
    n0 = paged_attention.launches
    got = paged_attention(*qkv, *tl, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    assert got.dtype == dtype
    want = paged_attention_ref(*qkv, *tl, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOLERANCE[dtype], rtol=0)
    assert not got[torch.from_numpy(lens == 0).to(dev)].any()


def split_cases():
    """Split-K cases: (name, shape, seq_lens, window), lengths placed on
    the splits that ``split_plan`` chooses for the shape."""
    shape = dict(b=4, kvh=4, group=2, dh=256, page=16, n_blocks=67)
    plan = split_plan(4, 4, 2, 256, 67)
    pp = plan.pages_per_split * shape["page"]       # tokens per split
    full = shape["n_blocks"] * shape["page"]
    # row 0's window starts inside split 5, inside one of its pages
    window = full - 5 - (5 * pp + 7)
    return [
        # a split's edge, one past it, one short of it; a full row
        ("split_edges", shape, [pp, pp + 1, pp - 1, full], None),
        ("window_mid_split", shape, [full - 5, full, 500, 0], window),
        # every split empty but the last (n_blocks % P != 0: it is short)
        ("only_last_split", shape, [full, 0, full - 3, 1], 10),
        ("empty_beside_full", shape, [0, full, 0, full], None),
        # b * kvh >= 264: one split, no scratch, no merge launch
        ("one_split", dict(b=66, kvh=4, group=2, dh=64, page=4, n_blocks=8),
         [(7 * i) % 33 for i in range(66)], None),
    ] + [
        # the MoE and hybrid layouts at the tables their 8-slot engines
        # serve: 66 blocks of 16 (max_seq 1056) and 17 (max_seq 264), where
        # split_plan picks other splits (qwen3-moe: P 8 / S 9 at 66, P 2 /
        # S 9 at 17; jamba: P 16 / S 5 at 66, P 4 / S 5 at 17)
        (f"{case}_{n}_blocks", dict(b=8, n_blocks=n, **{
            k: PAGED_CASES[case][k] for k in ("kvh", "group", "dh", "page")}),
         [0, 64, 65, 16 * n // 3, 8 * n, 16 * n - 8, 16 * n - 1, 16 * n],
         None)
        for case in ("granite_moe", "qwen3_moe", "jamba") for n in (17, 66)
    ] + [
        # the encoder families at the tables they are served with: whisper
        # (8 rows x kvh 20 = 160 blocks, so it splits) at 18 blocks
        # (prompts <= 224 + 64 new: P 16 / S 2) and at 66 (P 64 / S 2);
        # llama-3.2-vision at phase 3's 66 (P 16 / S 5)
        (f"{case}_{n}_blocks", dict(b=8, n_blocks=n, **{
            k: PAGED_CASES[case][k] for k in ("kvh", "group", "dh", "page")}),
         lens, None)
        for case, n, lens in (
            ("whisper", 18, [0, 1, 16, 17, 100, 224, 287, 288]),
            ("whisper", 66, [0, 64, 65, 700, 1023, 1024, 1025, 1056]),
            ("llama_vision", 66, [1056, 0, 1, 255, 256, 257, 800, 1040]))
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", split_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_k_matches_plain(case, softcap, dtype):
    dev = _cuda()
    name, shape, lens, window = case
    plan = split_plan(shape["b"], shape["kvh"], shape["group"], shape["dh"],
                      shape["n_blocks"])
    if name == "one_split":
        assert plan.n_splits == 1 and plan.scratch_shape is None
    else:
        assert plan.n_splits > 1 and shape["n_blocks"] % plan.pages_per_split
    q, k, v, tbl, sl = paged_case(5, seq_lens=lens, **shape)
    qkv = [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]
    tl = [torch.from_numpy(a).to(dev) for a in (tbl, sl)]
    n0 = paged_attention.launches
    got = paged_attention(*qkv, *tl, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    want = paged_attention_ref(*qkv, *tl, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOLERANCE[dtype], rtol=0)
    assert not got[torch.from_numpy(sl == 0).to(dev)].any()


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    q, k, v, tbl, lens = paged_case(4, **PAGED_CASES["smoke"])
    t = [torch.from_numpy(a).to(dev) for a in (q, k, v, tbl, lens)]
    with pytest.raises(ValueError):   # int64 table
        paged_attention(*t[:3], t[3].long(), t[4])
    with pytest.raises(ValueError):   # mixed dtypes
        paged_attention(t[0].to(torch.bfloat16), *t[1:])
    with pytest.raises(ValueError):   # head_dim not a multiple of 32
        paged_attention(t[0][..., :16], t[1][..., :16].contiguous(),
                        t[2][..., :16].contiguous(), *t[3:])


# --------------------------------------------------------------------------
# qsgd_pack (kernels/csrc/wire_compress.cu): bit-exact with the plain version
# --------------------------------------------------------------------------

QSGD_SHAPES = {
    "resnet20_stack": ((50, 2128, 128), 1),
    "mlr_stack": ((50, 62, 128), 1),
    "flat_1001": ((1001,), 0),
    "odd_stack": ((3, 1001), 1),
}


def _qsgd_inputs(shape, n_batch, seed, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.random(size=shape).astype(np.float32)).to(dev)
    batch = tuple(shape[:n_batch])
    norm = torch.sqrt(torch.sum(torch.square(x.reshape(batch + (-1,))), -1))
    return x, u, norm


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QSGD_SHAPES))
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_pack_kernel_equals_plain(case, bits):
    from repro_torch.kernels.wire_compress import (qsgd_inv, qsgd_pack,
                                                   qsgd_quantize_pack_ref)
    dev = _cuda()
    shape, nb = QSGD_SHAPES[case]
    x, u, norm = _qsgd_inputs(shape, nb, bits, dev)
    n0 = qsgd_pack.launches
    got = qsgd_pack(x, u, norm, bits=bits)
    torch.cuda.synchronize()
    assert qsgd_pack.launches == n0 + 1
    want = qsgd_quantize_pack_ref(x, u, qsgd_inv(norm, bits), bits=bits)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_pack_kernel_zero_plane_signed_zero_and_threshold(bits):
    from repro_torch.kernels.wire_compress import (qsgd_inv, qsgd_pack,
                                                   qsgd_quantize_pack_ref)
    dev = _cuda()
    x, u, _ = _qsgd_inputs((4, 62, 128), 1, 7, dev)
    zeros = torch.zeros_like(x)
    x = torch.where(torch.rand(x.shape, device=dev) < 0.3,
                    torch.where(x < 0, -0.0, 0.0), x)
    for vals in (zeros, x):
        norm = torch.sqrt(torch.sum(torch.square(vals.reshape(4, -1)), -1))
        inv = qsgd_inv(norm, bits)
        ratio = torch.abs(vals) * inv.reshape(4, 1, 1)
        uu = torch.where(torch.rand(x.shape, device=dev) < 0.5,
                         ratio - torch.floor(ratio), u)   # u == frac
        got = qsgd_pack(vals, uu, norm, bits=bits)
        assert torch.equal(got, qsgd_quantize_pack_ref(vals, uu, inv,
                                                       bits=bits))


@pytest.mark.cuda
def test_qsgd_pack_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels.wire_compress import qsgd_pack
    dev = _cuda()
    x, u, norm = _qsgd_inputs((2, 62, 128), 1, 3, dev)
    with pytest.raises(ValueError):            # f64 values
        qsgd_pack(x.double(), u.double(), norm, bits=4)
    with pytest.raises(ValueError):            # non-contiguous
        qsgd_pack(x.transpose(1, 2), u.transpose(1, 2), norm, bits=4)
    with pytest.raises(ValueError):            # mixed devices
        qsgd_pack(x, u.cpu(), norm, bits=4)


# --------------------------------------------------------------------------
# fixedk_gather_pack (kernels/csrc/wire_compress.cu): bit-exact with plain
# --------------------------------------------------------------------------

# (nodes, nb, kb, block): nb not a multiple of 8, kb = nb, nb/kb not an
# f32, a block that is no multiple of 4 (the scalar path)
GATHER_CASES = [(1, 37, 11, 1), (4, 37, 11, 8), (4, 37, 37, 128),
                (1, 130, 26, 128), (4, 1001, 333, 1), (2, 999, 100, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,kb,block", GATHER_CASES)
def test_fixedk_gather_pack_kernel_equals_plain(n, nb, kb, block):
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   fixedk_gather_pack_ref)
    dev = _cuda()
    rng = np.random.default_rng(nb + block)
    db = torch.from_numpy(rng.normal(size=(n, nb, block)).astype(
        np.float32)).to(dev)
    idx = torch.from_numpy(np.stack([rng.permutation(nb)[:kb]
                                     for _ in range(n)]).astype(np.int32)
                           ).to(dev)
    n0 = fixedk_gather_pack.launches
    got = fixedk_gather_pack(db, idx, scale=nb / kb)
    torch.cuda.synchronize()
    assert fixedk_gather_pack.launches == n0 + 1
    want = fixedk_gather_pack_ref(db, idx, scale=nb / kb)
    assert got.shape == (n, kb, block) and torch.equal(got, want)
    # the same inputs on the CPU take the plain version: no launch
    cpu = fixedk_gather_pack(db.cpu(), idx.cpu(), scale=nb / kb)
    assert fixedk_gather_pack.launches == n0 + 1
    assert torch.equal(cpu, want.cpu())


@pytest.mark.cuda
def test_fixedk_gather_pack_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels.wire_compress import fixedk_gather_pack
    dev = _cuda()
    db = torch.randn(2, 40, 8, device=dev)
    idx = torch.zeros(2, 10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):            # int64 indices
        fixedk_gather_pack(db, idx.long(), scale=4.0)
    with pytest.raises(ValueError):            # f64 values
        fixedk_gather_pack(db.double(), idx, scale=4.0)
    with pytest.raises(ValueError):            # mixed devices
        fixedk_gather_pack(db, idx.cpu(), scale=4.0)
    with pytest.raises(ValueError):            # indices do not batch
        fixedk_gather_pack(db, idx[:1], scale=4.0)


# --------------------------------------------------------------------------
# sdm_update (kernels/csrc/sdm_update.cu): equal to the plain version
# --------------------------------------------------------------------------

SDM_KW = dict(p=0.25, theta=0.4, gamma=0.05, sigma=0.7, clip_c=1.5,
              self_w=1.0 / 3.0)


def _sdm_operands(rows, seed, dev, high_bits=False):
    rng = np.random.default_rng(seed)
    shape = (rows, 1024)
    f = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
         for _ in range(4)]
    lo = 2**31 if high_bits else 0
    w = [torch.from_numpy(rng.integers(lo, 2**32, size=shape,
                                       dtype=np.uint32).view(np.int32)
                          ).to(dev) for _ in range(3)]
    return f + w


def _sdm_max_err(got, want):
    """0.0 when every output is bit-equal; else the largest difference,
    which must stay within the JAX kernel tests' 1e-6."""
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return 0.0
    return max((a - b).abs().max().item() for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,high_bits", [(8, False), (64, False),
                                            (256, True)])
@pytest.mark.parametrize("kw", [SDM_KW, dict(SDM_KW, sigma=0.0),
                                dict(SDM_KW, clip_c=None),
                                dict(SDM_KW, p=1.0, theta=1.0)],
                         ids=["default", "sigma0", "no_clip", "p1_theta1"])
def test_sdm_update_kernel_equals_plain(rows, high_bits, kw):
    from repro_torch.kernels.sdm_update import (sdm_update_planes,
                                                sdm_update_ref)
    dev = _cuda()
    ops = _sdm_operands(rows, rows, dev, high_bits)
    n0 = sdm_update_planes.launches
    got = sdm_update_planes(*ops, block_rows=8, **kw)
    torch.cuda.synchronize()
    assert sdm_update_planes.launches == n0 + 1
    want = sdm_update_ref(*ops, **kw)
    assert _sdm_max_err(got, want) <= 1e-6
    assert all(torch.isfinite(t).all() for t in got)
    # the same inputs on the CPU take the plain version: no launch
    cpu = sdm_update_planes(*(t.cpu() for t in ops), block_rows=8, **kw)
    assert sdm_update_planes.launches == n0 + 1
    assert _sdm_max_err([t.cpu() for t in got], cpu) <= 1e-6


@pytest.mark.cuda
def test_sdm_update_tree_wrapper_on_the_card_equals_the_cpu():
    from repro_torch import prng
    from repro_torch.kernels.sdm_update import sdm_update, sdm_update_planes
    dev = _cuda()
    rng = np.random.default_rng(2)
    shapes = {"conv": (3, 3, 16, 16), "bias": (16,), "dense": (64, 10)}
    trees = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(4)]
    n0 = sdm_update_planes.launches
    got = sdm_update(*({k: v.to(dev) for k, v in t.items()} for t in trees),
                     prng.PRNGKey(4), block_rows=8, **SDM_KW)
    assert sdm_update_planes.launches == n0 + 1
    want = sdm_update(*trees, prng.PRNGKey(4), block_rows=8, **SDM_KW)
    for g_tree, w_tree in zip(got, want):
        for name in shapes:
            assert _sdm_max_err([g_tree[name].cpu()], [w_tree[name]]) <= 1e-6


@pytest.mark.cuda
def test_sdm_update_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels.sdm_update import sdm_update_planes
    dev = _cuda()
    ops = _sdm_operands(8, 0, dev)
    with pytest.raises(ValueError):            # int64 bit words on the card
        sdm_update_planes(*ops[:4], *(w.long() for w in ops[4:]),
                          block_rows=8, **SDM_KW)
    with pytest.raises(ValueError):            # rows % block_rows
        sdm_update_planes(*ops, block_rows=16, **SDM_KW)
    with pytest.raises(ValueError):            # mixed devices
        sdm_update_planes(ops[0].cpu(), *ops[1:], block_rows=8, **SDM_KW)


# --------------------------------------------------------------------------
# flash_attention (kernels/csrc/flash_attn.cu): f32 2e-5, bf16 2e-2
# --------------------------------------------------------------------------

# (b, sq, skv, h, kvh, dh, block_q): every compiled head_dim, GQA 4 and 2,
# a ragged key count, query rows not a multiple of the kernel's 64-row tile
FLASH_SHAPES = [(2, 128, 160, 4, 4, 32, 128), (1, 256, 256, 8, 2, 64, 128),
                (1, 192, 192, 4, 2, 128, 64), (1, 96, 96, 8, 4, 256, 32)]
FLASH_MASKS = [dict(causal=False), dict(causal=True),
               dict(causal=True, window=16),          # window < key tile
               dict(causal=True, window=100, softcap=50.0),
               dict(causal=False, window=40)]


# bf16: each query row's max|kernel - plain| within 2^-5 of that row's own
# max|plain| (chip_smoke.py's FLASH_ROW_RTOL: p and the output are each
# rounded at 2^-8 of the row's scale)
FLASH_ROW_RTOL = 2 ** -5


def _assert_flash_close(got, want, dtype):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=TOLERANCE[dtype], rtol=0)
    if dtype == torch.bfloat16:
        row = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(
            1e-30)
        assert row.max().item() <= FLASH_ROW_RTOL


def _flash_inputs(b, sq, skv, h, kvh, dh, seed, dev, dtype, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32) * q_scale
    k = rng.normal(size=(b, skv, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, dh)).astype(np.float32)
    return [torch.from_numpy(t).to(dev, dtype) for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=[f"dh{s[5]}" for s in FLASH_SHAPES])
@pytest.mark.parametrize("mask", FLASH_MASKS,
                         ids=["full", "causal", "window16", "window100_cap",
                              "band40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(shape, mask, dtype):
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    dev = _cuda()
    b, sq, skv, h, kvh, dh, bq = shape
    rng = np.random.default_rng(sq + dh)
    q = torch.from_numpy(rng.normal(size=(b, sq, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, skv, kvh, dh)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(b, skv, kvh, dh)).astype(
        np.float32))
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, block_q=bq, **mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, **mask)
    _assert_flash_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 256])
@pytest.mark.parametrize("pattern", ["random", "permutation"])
def test_flash_bf16_single_tile_pins_the_fragment_layout(dh, pattern):
    """One 16 x 16 tile (one warp's rows, one m16n8k16 pair of key tiles):
    with a permutation pattern each query row sees one key ~e^11 above the
    rest, so its output is that key's v row, and a misplaced row or column
    of any fragment shows as a wrong row, not a rounding error."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    dev = _cuda()
    q, k, v = _flash_inputs(1, 16, 16, 1, 1, dh, dh, dev, torch.float32)
    if pattern == "permutation":
        perm = np.random.default_rng(dh).permutation(16)
        q = torch.zeros_like(q)
        k = torch.zeros_like(k)
        for i in range(16):
            k[0, i, 0, i] = 8.0
            q[0, i, 0, perm[i]] = 8.0 * dh ** 0.25
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q, k, v, causal=False, block_q=16)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=False)
    _assert_flash_close(got, want, torch.bfloat16)
    if pattern == "permutation":
        torch.testing.assert_close(got[0, :, 0].float(),
                                   v[0, perm, 0].float(), atol=2e-2, rtol=0)


# gemma2-like: dh 256, GQA 2; sq not a multiple of the 64-row query tile,
# skv not a multiple of the 32-key tile (dh 256)
GEMMA_FLASH = [(2, 200, 200, 8, 4, 256, 8), (1, 100, 173, 8, 4, 256, 4),
               (1, 330, 330, 4, 2, 256, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMMA_FLASH,
                         ids=[f"sq{s[1]}_skv{s[2]}" for s in GEMMA_FLASH])
@pytest.mark.parametrize("mask", [dict(causal=True, softcap=50.0),
                                  dict(causal=True, window=64, softcap=50.0),
                                  dict(causal=False),
                                  dict(causal=True, window=45)],
                         ids=["global", "local64", "full", "window45"])
def test_flash_bf16_gemma2_ragged_tiles(shape, mask):
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    dev = _cuda()
    b, sq, skv, h, kvh, dh, bq = shape
    q, k, v = _flash_inputs(b, sq, skv, h, kvh, dh, sq + skv, dev,
                            torch.bfloat16)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, block_q=bq, **mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _assert_flash_close(got, flash_attention_ref(q, k, v, **mask),
                        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_scores_near_the_softcap(causal):
    """q scaled by 40: |q.k| / sqrt(dh) ~ 30-50, where c tanh(s / c) with
    c = 50 bends the scores hardest (the case that decides whether the
    softcap's tanh may be the approximate one)."""
    dtype = torch.bfloat16
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    dev = _cuda()
    q, k, v = _flash_inputs(1, 192, 192, 8, 4, 256, 40, dev, dtype,
                            q_scale=40.0)
    raw = torch.einsum("bqhd,bkhd->bhqk", q.float()[:, :, :4],
                       k.float()).abs() / 16.0
    assert raw.median().item() > 20.0 and raw.max().item() > 50.0
    got = flash_attention(q, k, v, causal=causal, softcap=50.0, block_q=64)
    torch.cuda.synchronize()
    _assert_flash_close(got, flash_attention_ref(q, k, v, causal=causal,
                                                 softcap=50.0), dtype)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels.flash_attn.ops import flash_attention
    dev = _cuda()
    q = torch.randn(1, 64, 2, 48, device=dev)
    with pytest.raises(ValueError):            # head_dim 48
        flash_attention(q, q, q, block_q=64)
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError):            # mixed dtypes
        flash_attention(q, q.to(torch.bfloat16), q, block_q=64)
    with pytest.raises(ValueError):            # f16
        flash_attention(*(q.half() for _ in range(3)), block_q=64)


# --------------------------------------------------------------------------
# The ring helpers and the exchange left in flight (core/gossip.py,
# core/transport.py)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_gather_pack():
    """The gossip helpers' gather-pack routed to its plain version (what
    the kernel is held against), on any device."""
    from repro_torch.kernels import wire_compress

    kernel = wire_compress.fixedk_gather_pack
    wire_compress.fixedk_gather_pack = wire_compress.fixedk_gather_pack_ref
    try:
        yield
    finally:
        wire_compress.fixedk_gather_pack = kernel


def _ring(helper, d, **kw):
    from repro_torch import prng
    from repro_torch.core import gossip
    from repro_torch.core.transport import StackTransport

    t = StackTransport(d.shape[0], d.device)
    out = getattr(gossip, helper)(d, transport=t,
                                  base_key=prng.PRNGKey(42, device=d.device),
                                  step=3, p=0.3, neighbor_weight=0.25, **kw)
    assert t.permutes == 2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("helper,shape,kw", [
    ("ring_exchange_packed", (4, 1001), dict(block=1)),
    ("ring_exchange_packed", (4, 1001), dict(block=4)),
    ("ring_exchange_packed", (8, 130 * 128), dict(block=128)),
    ("ring_exchange_packed_rows", (4, 37, 16), {}),
    ("ring_exchange_packed_rows", (8, 999, 128), {})])
def test_ring_helpers_launch_gather_pack_and_equal_plain(helper, shape, kw):
    from repro_torch.kernels.wire_compress import fixedk_gather_pack

    dev = _cuda()
    rng = np.random.default_rng(sum(shape))
    d = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    n0 = fixedk_gather_pack.launches
    own, nb = _ring(helper, d, **kw)
    torch.cuda.synchronize()
    assert fixedk_gather_pack.launches == n0 + 1
    with plain_gather_pack():
        own_p, nb_p = _ring(helper, d, **kw)
    assert fixedk_gather_pack.launches == n0 + 1
    assert torch.equal(own, own_p) and torch.equal(nb, nb_p)
    assert own.shape == nb.shape == d.shape and bool(nb.abs().sum() > 0)


PLANE_TREE = {"emb": (9, 33), "w1": (64, 7), "b1": (71,), "w2": (3, 5, 11),
              "b2": (13,)}


def _overlap_run(meth_name, topo, transport, steps, churn=False,
                 waited=False):
    """``steps`` overlapped executor steps on 8 nodes; returns the settled
    final state's tensors and the transport's in-flight count after each
    step. ``churn`` frees and reallocates memory between steps;
    ``waited`` waits on each step's exchange before the next step (the
    in-order run)."""
    import gc

    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import gossip, method, sdm_dsgd
    from repro_torch.core.transport import settle

    n, dev = transport.n, transport.device
    rng = np.random.default_rng(6)
    tgt = {k: torch.from_numpy(rng.normal(size=(n,) + s).astype(
        np.float32)).to(dev) for k, s in PLANE_TREE.items()}
    block = {k: (0.1 * v[:1] + 0.05).expand_as(v).clone()
             for k, v in tgt.items()}
    meth = method.get(meth_name)
    cfg = meth.coerce_config(sdm_dsgd.SDMConfig(
        p=0.3, theta=0.4, gamma=0.1, sigma=0.05, clip_c=1.0,
        compressor="fixedk", overlap=True))
    ex = meth.make_distributed(gossip.sequence_by_name(topo, n), cfg,
                               transport)
    state = ex.init(block)
    in_flight = []
    for _ in range(steps):
        state, _ = ex.step(
            state, lambda x: (tree_mod.tree_map(torch.sub, x, tgt), None),
            base_key=prng.PRNGKey(7, device=dev))
        if waited:
            state = settle(state)
        in_flight.append(transport.outstanding)
        if churn:
            gc.collect()
            torch.cuda.empty_cache()
            junk = [torch.full((n, 4096), float(i), device=dev)
                    for i in range(64)]
            del junk
    state = settle(state)
    assert transport.outstanding == 0
    leaves = [v for v in tree_mod.leaves(state) if isinstance(v, torch.Tensor)]
    return leaves, in_flight


@pytest.mark.cuda
@pytest.mark.parametrize("meth_name,topo", [("sdm-dsgd", "ring"),
                                            ("gradient-push", "dring")])
def test_side_stream_overlap_equals_in_order(meth_name, topo):
    """5 overlapped steps with each exchange in flight on the side stream
    until the next step equal the in-order run (each exchange waited on
    inside its step), bit for bit; then again with memory freed and
    reused between the steps (the pending buffers are record_stream'd)."""
    from repro_torch.core.transport import StackTransport

    dev = _cuda()
    side, flights = _overlap_run(meth_name, topo, StackTransport(8, dev), 5)
    order, none = _overlap_run(meth_name, topo, StackTransport(8, dev), 5,
                               waited=True)
    churned, _ = _overlap_run(meth_name, topo, StackTransport(8, dev), 5,
                              churn=True)
    assert all(f > 0 for f in flights) and set(none) == {0}
    assert len(side) == len(order) == len(churned)
    for a, b, c in zip(side, order, churned):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_freed_send_buffer_is_not_reused_under_the_side_stream():
    """The side stream held busy, the send buffer freed and its memory
    asked for again on the current stream: the exchange still reads the
    values it was given (``record_stream``)."""
    from repro_torch.core.transport import StackTransport

    dev = _cuda()
    t = StackTransport(4, dev)
    ring = tuple((i, (i + 1) % 4) for i in range(4))
    x = torch.randn(4, 1 << 20, device=dev)
    want = torch.roll(x, 1, dims=0)
    with torch.cuda.stream(t.side_stream):
        torch.cuda._sleep(200_000_000)           # ~0.1 s at <= 2 GHz
    pend = t.ppermute_start(x, ring)
    del x
    junk = [torch.full((4, 1 << 20), 7.0, device=dev) for _ in range(8)]
    got = pend.wait()
    del junk
    torch.cuda.synchronize()
    assert t.outstanding == 0 and torch.equal(got, want)


@pytest.mark.cuda
def test_exchanges_not_deferred_stay_on_the_current_stream():
    """A plain ``ppermute`` and an executor run without ``overlap`` make
    every copy on the current stream: the transport's side stream is
    never made."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import gossip, method, sdm_dsgd
    from repro_torch.core.transport import StackTransport

    dev = _cuda()
    t = StackTransport(8, dev)
    x = torch.randn(8, 1000, device=dev)
    ring = tuple((i, (i + 1) % 8) for i in range(8))
    assert torch.equal(t.ppermute(x, ring), torch.roll(x, 1, dims=0))
    rng = np.random.default_rng(6)
    tgt = {k: torch.from_numpy(rng.normal(size=(8,) + s).astype(
        np.float32)).to(dev) for k, s in PLANE_TREE.items()}
    meth = method.get("sdm-dsgd")
    cfg = meth.coerce_config(sdm_dsgd.SDMConfig(
        p=0.3, theta=0.4, gamma=0.1, sigma=0.05, clip_c=1.0,
        compressor="fixedk", overlap=False))
    ex = meth.make_distributed(gossip.sequence_by_name("ring", 8), cfg, t)
    state = ex.init({k: torch.zeros_like(v) for k, v in tgt.items()})
    for _ in range(2):
        state, _ = ex.step(
            state, lambda x: (tree_mod.tree_map(torch.sub, x, tgt), None),
            base_key=prng.PRNGKey(7, device=dev))
    torch.cuda.synchronize()
    assert t._side is None and t.outstanding == 0 and t.permutes == 1 + 2 * 2


@pytest.mark.cuda
def test_restore_onto_the_card_through_the_staging_chunks(tmp_path,
                                                          monkeypatch):
    """``restore_checkpoint`` onto the card, its leaves read through
    staging chunks smaller than a leaf (and not dividing it), equals the
    restore on the host, bf16 leaves included."""
    from repro_torch.checkpoint import npz

    rng = np.random.default_rng(9)
    state = {"w": torch.from_numpy(rng.normal(size=(37, 129)).astype(
        np.float32)),
        "b": torch.from_numpy(rng.normal(size=(1001,)).astype(
            np.float32)).to(torch.bfloat16),
        "i": torch.arange(5, dtype=torch.int64), "e": torch.zeros(0),
        "step": 4}
    npz.save_checkpoint(str(tmp_path), 4, state)
    monkeypatch.setattr(npz, "_CHUNK", 1000)
    dev = _cuda()
    host = npz.restore_checkpoint(str(tmp_path), state)
    card = npz.restore_checkpoint(str(tmp_path), state, device=dev)
    assert card["step"] == 4
    for k in ("w", "b", "i", "e"):
        assert card[k].device.type == "cuda"
        assert card[k].dtype == state[k].dtype
        assert torch.equal(card[k].cpu(), host[k])
        assert torch.equal(host[k], state[k])
