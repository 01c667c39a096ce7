"""PyTorch port: the CUDA kernels against their plain versions, on the card.

The paged decode and prefill flash kernels are held at f32/bf16
tolerances; the qsgd_pack and fixedk_gather_pack kernels must equal their
plain versions bit for bit (``torch.equal``), the fused SDM update too or,
where a transcendental differs in its last bit, within 1e-6.

Imports no jax (the card's machine has none). Every test here is marked
``cuda`` and skips without a GPU; run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``paged_case`` / ``PAGED_CASES`` are shared with ``test_torch_decode.py``.
"""
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
