"""PyTorch port: the CUDA kernels against their plain versions, on the card.

The paged decode kernel is held at f32/bf16 tolerances; the qsgd_pack
and fixedk_gather_pack kernels must equal their plain versions bit for
bit (``torch.equal``).

Imports no jax (the card's machine has none). Every test here is marked
``cuda`` and skips without a GPU; run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``paged_case`` / ``PAGED_CASES`` are shared with ``test_torch_decode.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                   paged_attention_ref)


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
