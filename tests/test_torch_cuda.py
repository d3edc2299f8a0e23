"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU. The file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import functools

import pytest
import torch

from llm_mcp_tpu_torch.kernels import attention as P


def _card(seed):
    """(dev, g, rn, i32) on the card, or skip without one: the device, a
    seeded generator, bf16 normals and int32 tensors there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return dev, g, rn, i32


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the same bf16 inputs
    (small shapes, head_dim 128), element by element within
    |err| <= 1e-3 + 1e-2*|ref|: both sides accumulate in f32 and round the
    output to bf16 once, so they may differ by one bf16 step (at most 2^-7
    relative); append is bitwise."""
    dev, g, rn, i32 = _card(0)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, Hkv, G, S, hd = 2, 4, 2, 4, 640, 128
    ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
    # append: bitwise
    nk, nv = rn(L, 3, Hkv, hd), rn(L, 3, Hkv, hd)
    lens, ids = i32([0, S, 300]), i32([2, 0, 3])
    ak, av = ck.clone(), cv.clone()
    P.append_kv_bf16(ak, av, nk, nv, lens, slot_ids=ids)
    pk, pv = P.append_kv_plain(ck.clone(), cv.clone(), nk, nv, lens, ids)
    assert torch.equal(ak, pk) and torch.equal(av, pv)
    # decode
    q, nk1, nv1 = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens = i32([0, 257, S - 1, S])
    ids = i32([3, 1, 0, 2])
    out = P.decode_attend_bf16(q, nk1, nv1, ck, cv, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_plain(q, nk1, nv1, ck, cv, 1, lens, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # flash prefill
    H = Hkv * G
    qp, kp, vp = rn(2, H, 200, hd), rn(2, Hkv, 200, hd), rn(2, Hkv, 200, hd)
    for kw in (dict(), dict(window=40), dict(softcap=20.0, scale=0.05)):
        ln = i32([200, 0]) if not kw else i32([131, 200])
        out = P.flash_prefill_attention(qp, kp, vp, ln, **kw)
        ref = P.flash_prefill_plain(qp, kp, vp, ln, **kw)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
    # ragged prefill: rows with and without a cached prefix, and pads
    T, R = 96, 3
    rowids = i32([0] * 40 + [1] * 30 + [2] * 10 + [3] * 16)
    offsets, slots, starts = i32([0, 40, 70, 80]), i32([1, 3, 0]), i32([100, 0, 333])
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    out = P.ragged_prefill_attend_bf16(qr, kr, vr, ck, cv, 0, rowids, offsets, slots, starts)
    ref = P.ragged_prefill_plain(qr, kr, vr, ck, cv, 0, rowids, offsets, slots, starts)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 64, 128])
def test_cuda_paged_kernels_match_plain(bt):
    """The paged decode and ragged kernels against their plain versions
    (`paged_gather` + the same math) in bf16: tables whose first blocks
    resolve to pool rows in shuffled order and one block to another slot's
    arena home, random (scrambled) arena rows under every redirected
    block, a parked decode row and a ragged pad tail."""
    dev, g, rn, i32 = _card(bt)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, Hkv, G, S, hd = 2, 4, 2, 4, 512, 128
    nbs, pxb = S // bt, 6
    ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
    pk, pv = rn(L, pxb, Hkv, bt, hd), rn(L, pxb, Hkv, bt, hd)
    tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
    for b in range(B):  # rows share pool rows, in another order each
        tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
    tbl[1, 3] = 2 * nbs + 3  # slot 2's home block 3
    tbl = tbl.to(dev)
    paged = dict(block_tables=tbl, pool_k=pk, pool_v=pv)
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([5, 3 * bt + 7, S - 1, S]), i32([1, 3, 0, 2])  # row 3 parked
    out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, slot_ids=ids, scale=0.09, **paged)
    ref = P.decode_attend_paged_plain(q, nk, nv, ck, cv, 1, lens, tbl, pk, pv, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    T, R = 96, 3
    rowids = i32([0] * 40 + [1] * 30 + [2] * 10 + [3] * 16)
    offsets, slots, starts = i32([0, 40, 70, 80]), i32([1, 3, 0]), i32([3 * bt + 9, 0, 100])
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    args = (qr, kr, vr, ck, cv, 0, rowids, offsets, slots, starts)
    out = P.ragged_prefill_attend_bf16(*args, **paged)
    ref = P.ragged_prefill_paged_plain(*args, tbl, pk, pv)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


def _fused_cache(g, dev, L, B, Hkv, S, hd, packed=True):
    """A random fused int8 cache on the card: int8 payload, bf16 scales
    around 0.02, and with `packed` the pseudo-head holding the same scales
    (`pack_scales`), as the engine's writes keep it."""
    from llm_mcp_tpu_torch.models.quant import pack_scales

    pay = torch.randint(-127, 128, (L, B, 2 * Hkv, S, hd), generator=g, device=dev,
                        dtype=torch.int8)
    s = (torch.rand((L, B, 2 * Hkv, S), generator=g, device=dev) * 0.04).to(torch.bfloat16)
    if packed:
        pay = torch.cat([pay, pack_scales(s, hd)], dim=2)
    return {"q": pay.contiguous(), "s": s}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_cuda_q8_kernels_match_plain(packed):
    """The int8 kernels against their plain versions on the card: append
    bitwise ("q" and "s", the packed pseudo-head included), the decode
    kernel with the same requantization group (the contiguous wrapper's
    q8_group(S)) and the ragged kernel, element by element within
    |err| <= 1e-3 + 1e-2*|ref| (both sides round the output to bf16 once;
    a probability that the two sides' exp rounds to neighbouring int8
    steps moves the output by far less); with the packed pseudo-head
    (p = 1) and without it (p = 0)."""
    dev, g, rn, i32 = _card(3)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, Hkv, G, S, hd = 2, 4, 2, 4, 640, 128
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    # append: bitwise
    nk, nv = rn(L, 3, Hkv, hd), rn(L, 3, Hkv, hd)
    lens, ids = i32([0, S, 300]), i32([2, 0, 3])
    got = {k: v.clone() for k, v in cache.items()}
    P.append_kv_q8(got, {}, nk, nv, lens, slot_ids=ids)
    want = P.append_kv_q8_plain({k: v.clone() for k, v in cache.items()}, nk, nv, lens, ids)
    torch.cuda.synchronize()
    assert torch.equal(got["q"], want["q"]) and torch.equal(got["s"], want["s"])
    # decode: S = 640 requantizes per 128 keys (q8_group)
    q, nk1, nv1 = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([0, 257, S - 1, S]), i32([3, 1, 0, 2])
    out = P.decode_attend_q8(q, nk1, nv1, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk1, nv1, cache, 1, lens, ids, 0.09, P.q8_group(S))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # ragged: rows with and without a cached prefix, and pads
    T, R = 96, 3
    rowids = i32([0] * 40 + [1] * 30 + [2] * 10 + [3] * 16)
    offsets, slots, starts = i32([0, 40, 70, 80]), i32([1, 3, 0]), i32([100, 0, 333])
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    args = (qr, kr, vr, cache, 0, rowids, offsets, slots, starts)
    out = P.ragged_prefill_attend_q8(*args)
    ref = P.ragged_prefill_q8_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [32, 64, 128])
def test_cuda_q8_paged_kernels_match_plain(bt):
    """The paged int8 kernels against their plain versions: pool rows in
    shuffled order and a foreign arena home under scrambled arena blocks,
    requantization per bt keys, a parked decode row and a ragged pad tail."""
    dev, g, rn, i32 = _card(bt + 1)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, Hkv, G, S, hd = 2, 4, 2, 4, 512, 128
    nbs, pxb = S // bt, 6
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd)
    pool = _fused_cache(g, dev, L, pxb, Hkv, bt, hd)
    tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
    for b in range(B):
        tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
    tbl[1, 3] = 2 * nbs + 3
    tbl = tbl.to(dev)
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([5, 3 * bt + 7, S - 1, S]), i32([1, 3, 0, 2])
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09,
                             block_tables=tbl, pool_k=pool)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, bt, tbl, pool)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    T, R = 96, 3
    rowids = i32([0] * 40 + [1] * 30 + [2] * 10 + [3] * 16)
    offsets, slots, starts = i32([0, 40, 70, 80]), i32([1, 3, 0]), i32([3 * bt + 9, 0, 100])
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    args = (qr, kr, vr, cache, 0, rowids, offsets, slots, starts)
    out = P.ragged_prefill_attend_q8(*args, block_tables=tbl, pool=pool)
    ref = P.ragged_prefill_q8_plain(*args, 0.0, tbl, pool)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_qdot_int8_gemm_is_bitwise_the_host():
    """w8a8 `qdot` on the card (the int8 GEMM of `torch._int_mm`, rows
    padded, the payload row-major or K-contiguous) equals the same call on
    the host CPU bit for bit: the int8 operands are the same and the int32
    sum is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from llm_mcp_tpu_torch.models.quant import qdot, quantize_weight

    g = torch.Generator().manual_seed(5)
    w = quantize_weight(torch.randn((512, 384), generator=g).to(torch.bfloat16))
    # the row-major payload and the K-contiguous one of `gemm_layout`
    kmajor = {"q": w["q"].t().contiguous().t(), "s": w["s"]}
    for rows in (1, 8, 17, 40):
        x = torch.randn((rows, 512), generator=g).to(torch.bfloat16)
        host = qdot(x, w)
        for ww in (w, kmajor):
            card = qdot(x.cuda(), {k: v.cuda() for k, v in ww.items()})
            assert torch.equal(card.cpu(), host), rows


def _latent_planes(g, dev, L, rows, S, R=512, dr=64):
    """A random int8 latent cache (or pool) on the card: payloads and bf16
    per-token scales around 0.02, as `models/mla.py` writes them."""
    def plane(w):
        return {"q": torch.randint(-127, 128, (L, rows, 1, S, w), generator=g, device=dev,
                                   dtype=torch.int8),
                "s": (torch.rand((L, rows, 1, S), generator=g, device=dev) * 0.04)
                .to(torch.bfloat16)}
    return plane(R), plane(dr)


@pytest.mark.cuda
@pytest.mark.parametrize("bt,S", [(0, 640), (32, 640), (64, 640), (128, 640), (0, 16384),
                                  (64, 16384), (0, 65536), (256, 1024)])
def test_cuda_mla_decode_matches_plain(monkeypatch, bt, S):
    """The MLA int8 decode kernel against its plain version on the card, at
    DeepSeek-V2-Lite's widths (16 heads, R = 512, dr = 64), with the group
    the wrapper picks as JAX would: at S = 640 contiguous (bt = 0) the
    whole row, then a 128-key block group (the whole-S arm patched off);
    paged through tables of pool rows and a foreign arena home, group bt
    (256 spans two of the kernel's 128-key splits);
    at S = 16384, past the whole-S budget, the blocked arm's 512-key group
    and through 64-token tables (256 blocks) the exact group 0, both
    splitting a row into chunks; at S = 65536, past the blocked arm's 64
    blocks, the exact group 0 without tables. A parked row and rows permuted through
    slot_ids; |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(11 + bt + S)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, H, R, dr, Ba = 2, 6, 16, 512, 64, 4
    cc, cr = _latent_planes(g, dev, L, B, S)
    qt, qr, nc, nr = rn(Ba, H, R), rn(Ba, H, dr), rn(Ba, R), rn(Ba, dr)
    lens, ids = i32([0, S // 2 - 63, S - 1, S]), i32([5, 1, 0, 2])  # row 3 parked
    kw = dict(slot_ids=ids, scale=0.07)
    nbs = S // bt if bt else None
    if bt:
        pxb = 6
        pc, pr = _latent_planes(g, dev, L, pxb, bt)
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
        tbl[1, 3] = 2 * nbs + 3
        kw.update(block_tables=tbl.to(dev), pool_c=pc, pool_r=pr)

    def check(group):
        out = P.decode_attend_q8_mla(qt, qr, nc, nr, cc, cr, 1, lens, **kw)
        ref = P.decode_attend_q8_mla_plain(
            qt, qr, nc, nr, cc, cr, 1, lens, ids, 0.07, group, kw.get("block_tables"),
            kw.get("pool_c"), kw.get("pool_r"))
        torch.testing.assert_close(out.float(), ref.float(), **tol)

    want = {(0, 640): S, (0, 16384): 512, (64, 16384): 0, (0, 65536): 0}.get((bt, S), bt)
    assert P.mla_decode_group(S, R, dr, H, nbs) == want
    check(want)
    if (bt, S) == (0, 640):  # the blocked arm's group: the whole-S arm off
        monkeypatch.setattr(P, "mla_whole_s_fits", lambda *a, **k: False)
        assert P.mla_decode_group(S, R, dr, H) == 128
        check(128)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole", "blocked", "bt32", "bt64", "bt256", "exact",
                                  "heads32", "heads4"])
def test_cuda_mla_decode_split_edges(monkeypatch, case):
    """The MLA decode kernel's split (128 keys a CTA, all heads of a row in
    one CTA) against its plain version: w on a split boundary (128), one
    before it and one after it, a row of one key (w = 0) beside a full row,
    a parked row; the whole-row group over five splits (S = 640), the
    128-key block group, tables of 32-, 64- and 256-token blocks (groups
    inside a split, and one spanning two), the exact group (16-token
    tables), and 32 and 4 heads (two head groups, and part of one). Two
    calls agree bit for bit: the partials combine in split order, with no
    atomics. |err| <= 1e-3 + 1e-2*|ref|."""
    H = {"heads32": 32, "heads4": 4}.get(case, 16)
    bt = {"bt32": 32, "bt64": 64, "bt256": 256, "exact": 16}.get(case, 0)
    S = 1024 if bt == 256 else 640
    dev, g, rn, i32 = _card(29 + len(case) + bt + H)
    L, B, R, dr = 2, 7, 512, 64
    cc, cr = _latent_planes(g, dev, L, B, S)
    lens = i32([128, 127, 129, 0, S - 1, S, 255])  # row 5 parked
    ids = i32([6, 1, 0, 2, 4, 3, 5])
    Ba = lens.shape[0]
    qt, qr, nc, nr = rn(Ba, H, R), rn(Ba, H, dr), rn(Ba, R), rn(Ba, dr)
    kw = dict(slot_ids=ids, scale=0.07)
    nbs = S // bt if bt else None
    if bt:
        pxb = 5
        pc, pr = _latent_planes(g, dev, L, pxb, bt)
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            for j in range(nbs):
                if (b + j) % 3 == 0:
                    tbl[b, j] = B * nbs + (b + j) % pxb  # a pool row
                elif (b + j) % 3 == 1:
                    tbl[b, j] = ((b + 2) % B) * nbs + j  # another slot's home
        kw.update(block_tables=tbl.to(dev), pool_c=pc, pool_r=pr)
    if case == "blocked":
        monkeypatch.setattr(P, "mla_whole_s_fits", lambda *a, **k: False)
    group = P.mla_decode_group(S, R, dr, H, nbs)
    assert group == {"blocked": 128, "exact": 0}.get(case, bt or S)
    args = (qt, qr, nc, nr, cc, cr, 1, lens)
    out = P.decode_attend_q8_mla(*args, **kw)
    again = P.decode_attend_q8_mla(*args, **kw)
    ref = P.decode_attend_q8_mla_plain(*args, ids, 0.07, group, kw.get("block_tables"),
                                       kw.get("pool_c"), kw.get("pool_r"))
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(out[5].float(), nc[5].float().expand(H, R), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bt", [0, 32, 64])
def test_cuda_mla_ragged_matches_plain(quant, bt):
    """The ragged MLA kernel against its plain version on the card, bf16
    and int8 latents, contiguous (bt = 0) and paged, at V2-Lite's widths:
    rows with and without a cached prefix and a pad tail."""
    dev, g, rn, i32 = _card(21 + bt)
    tol = dict(atol=1e-3, rtol=1e-2)
    L, B, H, S, R, dr = 2, 4, 16, 512, 512, 64
    if quant:
        cc, cr = _latent_planes(g, dev, L, B, S)
    else:
        cc, cr = rn(L, B, 1, S, R), rn(L, B, 1, S, dr)
    T = 96
    rowids = i32([0] * 40 + [1] * 30 + [2] * 10 + [3] * 16)
    offsets, slots, starts = i32([0, 40, 70, 80]), i32([1, 3, 0]), i32([130, 0, 333])
    qt, qr, cs, krs = rn(T, H, R), rn(T, H, dr), rn(T, R), rn(T, dr)
    kw = {}
    if bt:
        nbs, pxb = S // bt, 6
        if quant:
            pc, pr = _latent_planes(g, dev, L, pxb, bt)
        else:
            pc, pr = rn(L, pxb, 1, bt, R), rn(L, pxb, 1, bt, dr)
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
        tbl[1, 3] = 2 * nbs + 3
        kw = dict(block_tables=tbl.to(dev), pool_c=pc, pool_r=pr)
    args = (qt, qr, cs, krs, cc, cr, 1, rowids, offsets, slots, starts)
    out = P.ragged_prefill_attend_mla(*args, scale=0.07, **kw)
    ref = P.ragged_prefill_mla_plain(*args, 0.07, kw.get("block_tables"), kw.get("pool_c"),
                                     kw.get("pool_r"))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bt", [0, 32, 64, 128, 256])
@pytest.mark.parametrize("H", [4, 16, 32])
def test_cuda_mla_ragged_tile_edges(H, bt, quant):
    """The ragged MLA kernel's 64-row tile (64 / H tokens) at its edges,
    against its plain version within |err| <= 1e-3 + 1e-2*|ref|: H in
    {4, 16, 32}; T * H not a multiple of 64 (the last tile's missing rows
    load zeros and store nothing); odd row lengths, so tiles straddle two
    descriptor rows and the last row and the pads; an empty row (hi = lo)
    whose start is not 0; prefixes of 0, 31, 32, 33 and 64 keys (inside,
    at and past a 32-key tile), of S and past S (clipped); contiguous
    (bt = 0) and through tables at bt in {32, 64, 128, 256}, the first two
    blocks of every row in pool rows and the third in another slot's arena
    home. At int8 the rope scales lie in another range than the latent
    scales, so swapping them changes every past score."""
    dev, g, rn, i32 = _card(700 + 10 * H + bt + quant)
    L, B, S, R, dr, pxb = 2, 8, 1024, 512, 64, 8
    ns = [5, 3, 0, 7, 1, 6, 9, 2]  # row 2 is empty
    starts = [0, 31, 17, 32, 33, 64, S, S + 100]
    Rn = len(ns)
    T = sum(ns) + 6  # six pads: T odd, so T * H % 64 != 0 for every H here
    assert (T * H) % 64
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [Rn] * (T - sum(ns)))
    offsets = i32([sum(ns[:r]) for r in range(Rn + 1)])
    slots = i32([3, 0, 5, 1, 7, 2, 6, 4])

    def latents(rows, tokens):
        if not quant:
            return rn(L, rows, 1, tokens, R), rn(L, rows, 1, tokens, dr)
        c, r = _latent_planes(g, dev, L, rows, tokens)
        r["s"] = (r["s"].float() + 0.04).to(torch.bfloat16)  # rope scales in [0.04, 0.08)
        return c, r

    cc, cr = latents(B, S)
    qt, qr, cs, krs = rn(T, H, R), rn(T, H, dr), rn(T, R), rn(T, dr)
    kw = {}
    if bt:
        nbs = S // bt
        pc, pr = latents(pxb, bt)
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            tbl[b, :2] = B * nbs + torch.tensor([(b + j) % pxb for j in range(2)])
            tbl[b, 2] = ((b + 3) % B) * nbs + 2
        kw = dict(block_tables=tbl.to(dev), pool_c=pc, pool_r=pr)
    args = (qt, qr, cs, krs, cc, cr, 1, rowids, offsets, slots, i32(starts))
    out = P.ragged_prefill_attend_mla(*args, scale=0.07, **kw)
    ref = P.ragged_prefill_mla_plain(*args, 0.07, kw.get("block_tables"), kw.get("pool_c"),
                                     kw.get("pool_r"))
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_mla_ragged_refuses_heads_not_dividing_64():
    """The MLA ragged tile holds 64 (token, head) rows, so the wrapper
    refuses a head count that does not divide 64, before any launch."""
    dev, g, rn, i32 = _card(790)
    T, H, S = 6, 48, 64
    cc, cr = rn(1, 2, 1, S, 512), rn(1, 2, 1, S, 64)
    args = (rn(T, H, 512), rn(T, H, 64), rn(T, 512), rn(T, 64), cc, cr, 0,
            i32([0] * T), i32([0, T]), i32([1]), i32([10]))
    before = P.LAUNCHES["ragged_prefill_attend_mla"]
    with pytest.raises(ValueError, match="heads dividing 64"):
        P.ragged_prefill_attend_mla(*args, scale=0.1)
    assert P.LAUNCHES["ragged_prefill_attend_mla"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4])
def test_cuda_decode_attention_matches_plain(G):
    """The post-append decode kernel against its plain version: lengths 0,
    mid-row, S - 1, >= S (all S) and -1 (the mean of V over S), on a row
    that splits into several chunks; |err| <= 1e-3 + 1e-2*|ref|."""
    _, _, rn, i32 = _card(50 + G)
    B, Hkv, S, hd = 6, 2, 1000, 128
    q, ck, cv = rn(B, Hkv, G, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    lens = i32([0, 300, S - 1, S, S + 5, -1])
    out = P.decode_attention(q, ck, cv, lens)
    ref = P.decode_attention_plain(q, ck, cv, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [67, 200, 640])
@pytest.mark.parametrize("G", [1, 4, 6, 7, 8])
def test_cuda_flash_prefill_tile_edges(S, G):
    """The wgmma prefill tile at its edges: S not a multiple of 64 (a short
    last query tile and key tile), every G, a row of length 0 (emits 0),
    lengths inside a tile, a sliding window, softcap with a scale."""
    _, _, rn, i32 = _card(S + G)
    B, Hkv, hd = 3, 2, 128
    H = Hkv * G
    q, k, v = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    ln = i32([S, 0, S // 2 + 3])
    for kw in (dict(), dict(window=37), dict(softcap=20.0, scale=0.05)):
        out = P.flash_prefill_attention(q, k, v, ln, **kw)
        ref = P.flash_prefill_plain(q, k, v, ln, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
        assert not out[1].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 6, 7, 8])
@pytest.mark.parametrize("arm", ["bf16", "q8"])
@pytest.mark.parametrize("bt", [0, 32, 64, 128])
def test_cuda_ragged_prefill_tile_edges(G, arm, bt):
    """The ragged kernels on the wgmma tile: CTAs whose tokens straddle two
    descriptor rows, a pad tail, prefixes that end inside a 64-key tile,
    contiguous (bt = 0) and through tables at bt in {32, 64, 128} (pool
    rows in shuffled order, a foreign arena home); bf16 and int8 caches."""
    _ragged_tile_case(G, arm, bt, 128)


def _ragged_tile_case(G, arm, bt, hd):
    """The body of `test_cuda_ragged_prefill_tile_edges` at head_dim hd; a
    second call must repeat the first bit for bit, each launch counted."""
    dev, g, rn, i32 = _card(100 * G + bt + (arm == "q8") + (hd != 128) * 1600)
    L, B, Hkv, S, pxb = 2, 4, 2, 512, 6
    ns = [7, 21, 50, 13]
    T, R = sum(ns) + 9, len(ns)
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [R] * (T - sum(ns)))
    offsets = i32([sum(ns[:r]) for r in range(R + 1)])
    slots, starts = i32([2, 0, 3, 1]), i32([37, 0, 130, 201])
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    kw, tbl = {}, None
    if bt:
        nbs = S // bt
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
        tbl[1, 3] = 2 * nbs + 3
        tbl = tbl.to(dev)
    if arm == "q8":
        cache = _fused_cache(g, dev, L, B, Hkv, S, hd)
        args = (qr, kr, vr, cache, 1, rowids, offsets, slots, starts)
        pool = _fused_cache(g, dev, L, pxb, Hkv, bt, hd) if bt else None
        call = functools.partial(P.ragged_prefill_attend_q8, *args, scale=0.07,
                                 block_tables=tbl, pool=pool)
        ref = P.ragged_prefill_q8_plain(*args, 0.07, tbl, pool)
    else:
        ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
        args = (qr, kr, vr, ck, cv, 1, rowids, offsets, slots, starts)
        if bt:
            pk, pv = rn(L, pxb, Hkv, bt, hd), rn(L, pxb, Hkv, bt, hd)
            kw = dict(block_tables=tbl, pool_k=pk, pool_v=pv)
            ref = P.ragged_prefill_paged_plain(*args, tbl, pk, pv, 0.07)
        else:
            ref = P.ragged_prefill_plain(*args, 0.07)
        call = functools.partial(P.ragged_prefill_attend_bf16, *args, scale=0.07, **kw)
    counter = P._arm(f"ragged_prefill_attend_{arm}" + ("_paged" if bt else ""), hd)
    before = P.LAUNCHES[counter]
    out = call()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    assert torch.equal(out, call())
    assert P.LAUNCHES[counter] == before + 2
    torch.cuda.synchronize()


def _decode_case(rn, i32, L, B, Hkv, G, S, hd):
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    return q, nk, nv, rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 6, 7, 8])
def test_cuda_decode_bf16_split_edges(monkeypatch, G, chunk):
    """The bf16 decode kernel (cp.async ring of 32-key stages, per-warp
    keys and softmax) against its plain version at every edge of its
    design: w = 0, a stage edge (31, 32), a split edge (chunk - 1, chunk),
    past two splits, S - 1, and a row parked at S; rows permuted through
    slot_ids; |err| <= 1e-3 + 1e-2*|ref|."""
    _, _, rn, i32 = _card(200 + 10 * G + chunk)
    monkeypatch.setattr(P, "DECODE_CHUNK_BF16", chunk)
    L, B, Hkv, S, hd = 2, 8, 2, 640, 128
    q, nk, nv, ck, cv = _decode_case(rn, i32, L, B, Hkv, G, S, hd)
    lens = i32([0, 31, 32, chunk - 1, chunk, 2 * chunk + 17, S - 1, S])
    ids = i32([5, 2, 7, 0, 3, 6, 1, 4])
    out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_plain(q, nk, nv, ck, cv, 1, lens, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("bt", [32, 64, 128, 256])
def test_cuda_decode_bf16_paged_edges(monkeypatch, bt, chunk):
    """The paged bf16 decode kernel against its plain version at every
    block size the physical layout takes: each row's first three blocks
    in pool rows (shuffled order), one block in another slot's arena home,
    scrambled arena rows under every redirected block, w inside a pool
    block (at a stage edge and at a block's last key), inside the foreign
    home, at S - 1 and parked at S."""
    dev, _, rn, i32 = _card(300 + bt + chunk)
    monkeypatch.setattr(P, "DECODE_CHUNK_BF16", chunk)
    L, B, Hkv, G, S, hd, pxb = 2, 6, 2, 4, 1024, 128, 5
    nbs = S // bt
    q, nk, nv, ck, cv = _decode_case(rn, i32, L, B, Hkv, G, S, hd)
    pk, pv = rn(L, pxb, Hkv, bt, hd), rn(L, pxb, Hkv, bt, hd)
    tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
    for b in range(B):
        tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
    tbl[1, 3] = 4 * nbs + 3  # slot 1's block 3 lives in slot 4's home
    tbl = tbl.to(dev)
    lens = i32([0, 32, 3 * bt - 1, 3 * bt + 7, S - 1, S])
    ids = i32([2, 0, 4, 1, 5, 3])  # the row at 3 * bt + 7 reads slot 1
    paged = dict(block_tables=tbl, pool_k=pk, pool_v=pv)
    out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, slot_ids=ids, scale=0.09, **paged)
    ref = P.decode_attend_paged_plain(q, nk, nv, ck, cv, 1, lens, tbl, pk, pv, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 8])
def test_cuda_decode_attention_split_edges(monkeypatch, G, chunk):
    """The post-append arm of the same kernel at lengths -1 (the mean of V
    over S), 0, the stage and split edges, mid-row, S - 1 and >= S (all
    S), inclusive mask; |err| <= 1e-3 + 1e-2*|ref|."""
    _, _, rn, i32 = _card(400 + G + chunk)
    monkeypatch.setattr(P, "DECODE_CHUNK_BF16", chunk)
    B, Hkv, S, hd = 10, 2, 1000, 128
    q, ck, cv = rn(B, Hkv, G, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    lens = i32([-1, 0, 31, 32, chunk - 1, chunk, 500, S - 1, S, S + 3])
    out = P.decode_attention(q, ck, cv, lens)
    ref = P.decode_attention_plain(q, ck, cv, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_decode_split_sizes_passed(monkeypatch):
    """The bf16 decode wrappers pass DECODE_CHUNK_BF16 and the int8 ones
    still pass DECODE_CHUNK = 256 (the int8 kernel takes whole
    requantization groups of at most 256 keys), each with S / chunk
    splits, and both still match their plain versions."""
    dev, g, rn, i32 = _card(500)
    seen = {}
    launch = P._launch

    def spy(name, symbol, *args):
        seen[symbol] = args
        launch(name, symbol, *args)

    monkeypatch.setattr(P, "_launch", spy)
    L, B, Hkv, G, S, hd = 2, 4, 2, 4, 1024, 128
    q, nk, nv, ck, cv = _decode_case(rn, i32, L, B, Hkv, G, S, hd)
    lens, ids = i32([0, 300, S - 1, S]), i32([3, 1, 0, 2])
    out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_plain(q, nk, nv, ck, cv, 1, lens, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    # pointers (11), layer, B, Ba, Hkv, G, S, hd, then chunk and nsplit
    assert seen["decode_attend_bf16"][18:20] == (P.DECODE_CHUNK_BF16, S // P.DECODE_CHUNK_BF16)
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd)
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, P.q8_group(S))
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    # pointers (11), layer, B, Ba, Hkv, Hf, G, S, hd, then chunk and nsplit
    assert P.DECODE_CHUNK == 256
    assert seen["decode_attend_q8"][19:21] == (256, S // 256)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("S", [1000, 4072])
def test_cuda_q8_decode_exact_group(S, packed):
    """At a cache length that no int8 group divides (not a multiple of 32:
    `q8_group(S)` is 0) and past JAX's whole-S budget (744 keys at
    Llama-2-7B's 32 KV heads of 128, G = 1) the contiguous int8 decode
    takes its exact arm, the arithmetic of JAX's
    `_decode_attend_q8_fallback`, and matches
    `decode_attend_q8_plain(group=0)`: q and p in f32, no requantization;
    w at 0, beside a split edge, at S - 1 and parked;
    |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(600 + S + packed)
    L, B, Hkv, G, hd = 2, 6, 32, 1, 128
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([0, 255, 256, S // 2, S - 1, S]), i32([5, 2, 0, 4, 1, 3])
    assert P.q8_group(S) == 0 and P.q8_decode_plan(S, hd, Hkv, Hkv * G)[0] == 0
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    again = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("Hkv,S", [(2, 1000), (2, 4072), (8, 1000)])
def test_cuda_q8_decode_whole_row(Hkv, S, packed):
    """At a cache length that no int8 group divides but that fits JAX's
    whole-S budget (11397 keys at Hkv 2, G 4; 2849 at Llama-3.1-8B's Hkv
    8) the contiguous int8 decode takes its whole-row arm (a score pass,
    then the split kernel under programmatic dependent launch) and matches
    `decode_attend_q8_plain(group=S)`, p requantized once over the whole
    row: w at 0, at a split edge (255, 256, 257), mid-row, S - 1 and
    parked; two calls agree bit for bit; |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(650 + S + Hkv + packed)
    L, B, G, hd = 2, 7, 4, 128
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([0, 255, 256, 257, S // 2, S - 1, S]), i32([5, 2, 0, 6, 4, 1, 3])
    assert P.q8_group(S) == 0 and P.q8_decode_plan(S, hd, Hkv, Hkv * G)[0] == S
    P.reset_launches()
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    again = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, S)
    torch.cuda.synchronize()
    assert P.LAUNCHES["decode_attend_q8_row"] == 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


# the fused append's arms: (arm, packed scales)
FUSED_APPEND_ARMS = [("bf16", True), ("bf16_paged", True), ("q8", True), ("q8", False),
                     ("q8_paged", True), ("q8_paged", False), ("q8_exact", True),
                     ("q8_exact", False), ("q8_row", True), ("q8_row", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("arm,packed", FUSED_APPEND_ARMS)
def test_cuda_decode_fused_append(arm, packed):
    """Every decode arm with `append=True`: its output equals the same call
    with `append=False` bit for bit, and the cache after it equals, bit for
    bit (payload, plain scales, packed pseudo-head), the cache after the
    `append=False` call followed by the plain append (`append_kv_plain` /
    `append_kv_q8_plain`) of that layer, and followed by the standalone
    append (`append_kv_bf16` / `append_kv_q8`): the same bytes at the same
    addresses, the slot's arena row at w through tables too, and nothing
    else. Rows at
    w = 0, at a split edge, at S - 1 and parked, compacted through
    slot_ids; the bf16 arms at split 128 (S = 640), the int8 group arm at
    S = 1024, the exact arm at 32 KV heads (S = 1000 past the whole-S
    budget), the whole-row arm at S = 1000, the paged arms at 64-token
    blocks with pool rows and foreign homes."""
    _fused_append_case(arm, packed, 128)


def _fused_append_case(arm, packed, hd):
    """The body of `test_cuda_decode_fused_append` at head_dim hd."""
    dev, g, rn, i32 = _card(1300 + FUSED_APPEND_ARMS.index((arm, packed)) + (hd != 128) * 50)
    L, B, layer = 3, 7, 1
    # the exact arm: a length past JAX's whole-S budget that no group divides
    # (at head_dim 64 the packed row holds the scales of 16 KV heads at most)
    exact = (32, 1, 1000) if hd == 128 else (16, 1, 4072)
    Hkv, G, S = {"q8_exact": exact, "q8_row": (2, 4, 1000)}.get(arm, (2, 4, 1024))
    if arm.startswith("bf16"):
        S = 640
    split = P.DECODE_CHUNK_BF16 if arm.startswith("bf16") else P.DECODE_CHUNK
    lens = i32([0, split - 1, split, S - 1, S])
    ids = i32([5, 2, 6, 0, 3])
    Ba = len(ids)
    q, nk, nv = rn(Ba, Hkv, G, hd), rn(Ba, Hkv, hd), rn(Ba, Hkv, hd)
    kw = dict(slot_ids=ids, scale=0.09)
    if arm.startswith("bf16"):
        cache = (rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd))
        if arm == "bf16_paged":
            bt, pxb = 64, 4
            nbs = S // bt
            tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
            tbl[5, :2] = B * nbs + torch.tensor([2, 0], dtype=torch.int32)
            tbl[2, 1] = 4 * nbs + 1
            kw.update(block_tables=tbl.to(dev), pool_k=rn(L, pxb, Hkv, bt, hd),
                      pool_v=rn(L, pxb, Hkv, bt, hd))

        def call(c, append):
            return P.decode_attend_bf16(q, nk, nv, c[0], c[1], layer, lens, append=append, **kw)

        def standalone(c):
            P.append_kv_bf16(c[0][layer:layer + 1], c[1][layer:layer + 1], nk[None], nv[None],
                             lens, slot_ids=ids)

        def plain(c):
            P.append_kv_plain(c[0][layer:layer + 1], c[1][layer:layer + 1], nk[None], nv[None],
                              lens, ids)

        def clone(c):
            return tuple(x.clone() for x in c)

        def same(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        counter = "append_kv_bf16_fused"
    else:
        if arm == "q8_paged":
            cache, pool, tbl, _ = _q8_paged_case(g, dev, L, B, Hkv, S, hd, 64, packed)
            kw.update(block_tables=tbl, pool_k=pool)
        else:
            cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
        group = P.q8_decode_plan(S, hd, Hkv, Hkv * G, None if arm != "q8_paged" else S // 64)[0]
        assert group == {"q8": 256, "q8_paged": 64, "q8_exact": 0, "q8_row": S}[arm]

        def call(c, append):
            return P.decode_attend_q8(q, nk, nv, c, {}, layer, lens, append=append, **kw)

        def standalone(c):  # the standalone kernel is built for head_dim 128: plain at 64
            rows = {k: v[layer:layer + 1] for k, v in c.items()}
            if hd == 128:
                P.append_kv_q8(rows, {}, nk[None], nv[None], lens, slot_ids=ids)
            else:
                P.append_kv_q8_plain(rows, nk[None], nv[None], lens, ids)

        def plain(c):
            P.append_kv_q8_plain({k: v[layer:layer + 1] for k, v in c.items()}, nk[None],
                                 nv[None], lens, ids)

        def clone(c):
            return {k: v.clone() for k, v in c.items()}

        def same(a, b):
            return all(torch.equal(a[k], b[k]) for k in a)
        counter = "append_kv_q8_fused"
    want = clone(cache)
    out = call(want, False)
    torch.cuda.synchronize()
    assert same(want, cache)  # append=False writes nothing
    standalone(want)
    ref = clone(cache)
    call(ref, False)
    plain(ref)
    got = clone(cache)
    P.reset_launches()
    fused = call(got, True)
    torch.cuda.synchronize()
    assert P.LAUNCHES[P._arm(counter, hd)] == 1
    assert torch.equal(fused, out)
    assert same(got, ref)
    assert same(got, want)
    assert not same(got, cache)


@pytest.mark.cuda
def test_cuda_int8_engine_serves_unaligned_seq_len():
    """An int8-KV engine at max_seq_len = 1000 (no 64-token block divides
    it, so the cache is contiguous, and no int8 group either) decodes on
    the card through the int8 decode kernel's whole-row arm (the row fits
    JAX's whole-S budget at these widths), appending from inside it.
    tiny-llm's structure at head_dim 128, the width the kernels are built
    for."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from dataclasses import replace

    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.models.configs import get_config

    cfg = replace(get_config("tiny-llm"), dim=512, n_heads=4, n_kv_heads=2)
    eng = GenerationEngine(cfg, max_slots=2, max_seq_len=1000, quant="int8", kv_quant="int8",
                           seed=0, device="cuda").start()
    try:
        P.reset_launches()
        out = eng.generate("user: hello there", max_tokens=6, temperature=0.0)
        torch.cuda.synchronize()
    finally:
        eng.shutdown()
    assert eng._phys is None and eng._ck["q"].shape[3] == 1000
    assert out["usage"]["completion_tokens"] == 6
    assert P.LAUNCHES["decode_attend_q8"] > 0
    assert P.LAUNCHES["decode_attend_q8_row"] == P.LAUNCHES["decode_attend_q8"]
    assert P.LAUNCHES["append_kv_q8_fused"] == P.LAUNCHES["decode_attend_q8"]
    assert P.LAUNCHES["append_kv_q8"] == 0


def _q8_paged_case(g, dev, L, B, Hkv, S, hd, bt, packed):
    """(arena, pool, tables, contiguous rows): tables whose blocks resolve,
    row by row, to pool rows (in another order each), to another slot's
    arena home, or to their own home; the arena under every redirected block
    scrambled; and the contiguous cache that the tables stand for."""
    nbs, pxb = S // bt, 5
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    pool = _fused_cache(g, dev, L, pxb, Hkv, bt, hd, packed)
    tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
    for b in range(B):
        for j in range(nbs):
            if (b + j) % 3 == 0:
                tbl[b, j] = B * nbs + (b + 2 * j) % pxb  # a pool row
            elif (b + j) % 3 == 1:
                tbl[b, j] = ((b + 2) % B) * nbs + j  # another slot's home
    tbl = tbl.to(dev)
    arena = cache
    redirected = (tbl.long() != torch.arange(B * nbs, device=dev).reshape(B, nbs)).cpu()
    for b in range(B):
        for j in range(nbs):
            if redirected[b, j]:
                for k in arena:
                    arena[k][:, b, :, j * bt:(j + 1) * bt] = torch.flip(
                        arena[k][:, b, :, j * bt:(j + 1) * bt], dims=[2])
    flat = {k: torch.stack([P.paged_gather(v[li], pool[k][li], tbl) for li in range(L)])
            .contiguous() for k, v in arena.items()}
    return arena, pool, tbl, flat


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4, 6, 7, 8])
def test_cuda_q8_decode_split_edges(G, packed):
    """The int8 decode kernel (a CTA per 256-key split, a warp per 64 keys
    in two 32-key stages, one exchange of maxima per split) against its
    plain version at every edge of its design, group 256 (S = 1024): w at
    0, a stage edge (31, 32), a warp edge (63, 64), a split edge (255, 256,
    257), S - 1, and a row parked at S; rows permuted through slot_ids; two
    calls agree bit for bit; the parked row is its new V exactly.
    |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(700 + 10 * G + packed)
    L, B, Hkv, S, hd = 2, 11, 2, 1024, 128
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    lens = i32([0, 31, 32, 63, 64, 255, 256, 257, 700, S - 1, S])
    ids = i32([5, 2, 7, 0, 3, 6, 1, 4, 10, 9, 8])
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    assert P.q8_decode_plan(S, hd, Hkv, Hkv * G) == (256, 256, 4)
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    again = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, 256)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(out[10], nv[10][:, None].expand(Hkv, G, hd), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("S", [608, 576, 640])
def test_cuda_q8_decode_groups(S, packed):
    """The contiguous arm at the other groups `q8_group` gives (32 keys at
    S = 608, 64 at 576, 128 at 640): each group's scale over its own keys,
    several groups a warp or a split. |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(800 + S + packed)
    L, B, Hkv, G, hd = 2, 6, 2, 4, 128
    cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    lens, ids = i32([0, 40, 255, 300, S - 1, S]), i32([3, 5, 0, 1, 4, 2])
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    group = {608: 32, 576: 64, 640: 128}[S]
    assert P.q8_decode_plan(S, hd, Hkv, Hkv * G)[0] == P.q8_group(S) == group
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, group)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bt", [32, 64, 128, 256])
def test_cuda_q8_decode_paged_edges(bt, packed):
    """The paged int8 decode (group bt) at every block size the physical
    layout takes, blocks in pool rows, in other slots' homes and in their
    own, the arena under redirected blocks scrambled: against its plain
    version, w at 0, at block and split edges, S - 1 and parked; and bit
    for bit the same call on the contiguous rows the tables stand for
    through identity tables. |err| <= 1e-3 + 1e-2*|ref|."""
    dev, g, rn, i32 = _card(900 + bt + packed)
    L, B, Hkv, G, hd, S = 2, 6, 2, 4, 128, 1024
    arena, pool, tbl, flat = _q8_paged_case(g, dev, L, B, Hkv, S, hd, bt, packed)
    lens = i32([0, bt - 1, 256, 257, S - 1, S])
    ids = i32([2, 0, 4, 1, 5, 3])
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    out = P.decode_attend_q8(q, nk, nv, arena, {}, 1, lens, slot_ids=ids, scale=0.09,
                             block_tables=tbl, pool_k=pool)
    ref = P.decode_attend_q8_plain(q, nk, nv, arena, 1, lens, ids, 0.09, bt, tbl, pool)
    ident = torch.arange(B * (S // bt), dtype=torch.int32, device=dev).reshape(B, S // bt)
    same = P.decode_attend_q8(q, nk, nv, flat, {}, 1, lens, slot_ids=ids, scale=0.09,
                              block_tables=ident, pool_k=pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    assert torch.equal(out, same)


# -- the decode round as a CUDA graph -------------------------------------

def _graph_cfg(kind: str):
    """tiny-llm's structure at head_dim 128, or tiny-v2's (MLA and MoE) at
    the latent widths the MLA kernels are built for (R 512, rope 64)."""
    from dataclasses import replace

    from llm_mcp_tpu_torch.models.configs import get_config

    if kind == "mla":
        return replace(get_config("tiny-v2"), dim=512, kv_lora_rank=512, qk_rope_head_dim=64,
                       qk_nope_head_dim=128, v_head_dim=128)
    return replace(get_config("tiny-llm"), dim=512, n_heads=4, n_kv_heads=2)


def _fill_random(tree, g) -> None:
    """Random cache (or pool) contents in place: bf16 normals, or int8
    payloads with positive scales; a fused cache's packed pseudo-head
    carries its scales, as every write path keeps it."""
    from llm_mcp_tpu_torch.models.quant import pack_scales

    if not isinstance(tree, dict):
        tree.copy_(torch.randn(tree.shape, generator=g, device=tree.device).to(tree.dtype))
        return
    if not tree:
        return
    q, s = tree["q"], tree["s"]
    q.copy_(torch.randint(-127, 128, q.shape, generator=g, device=q.device, dtype=torch.int8))
    s.copy_((torch.rand(s.shape, generator=g, device=s.device) * 0.02 + 1e-3).to(s.dtype))
    Hs = s.shape[2]
    if q.shape[2] > Hs:  # the packed pseudo-head
        q[:, :, Hs:Hs + 1] = pack_scales(s, q.shape[-1])


# name: (config, max_slots, int8, active rows, rows read through the pool)
ROUND_CASES = {
    "bf16": ("llm", 4, False, [0, 1, 3], []),
    "bf16_paged": ("llm", 4, False, [0, 2, 3], [2]),
    "int8_ba8": ("llm", 16, True, [1, 4, 6, 9, 13], []),
    "int8_ba16": ("llm", 32, True, list(range(0, 24, 2)), []),
    "int8_paged": ("llm", 16, True, [2, 5, 11], [5]),
    "mla": ("mla", 16, True, [0, 3, 9], []),
    "mla_paged": ("mla", 16, True, [0, 3, 9], [3]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_cuda_round_graph_matches_eager(case):
    """Three decode rounds of an engine's shape, eager and as one CUDA graph
    (`RoundGraphs`: the first call eager on a side stream, then capture,
    then two replays), from the same cache, pool, round state and
    generator seed: every round's tokens (a sampled row among greedy
    ones), the cache, the pool and the token ring bit for bit. After N
    replays the launch counters hold N times the graph's tally, which
    counts the decode kernel of every step and layer."""
    dev, g, _, _ = _card(900 + sorted(ROUND_CASES).index(case))
    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.executor.common import pow2_bucket
    from llm_mcp_tpu_torch.executor.graphs import RoundGraphs

    kind, B, q8, active, via_pool = ROUND_CASES[case]
    S, K = 512, 4
    eng = GenerationEngine(_graph_cfg(kind), max_slots=B, max_seq_len=S, seed=0,
                           quant="int8" if q8 else "", kv_quant="int8" if q8 else "",
                           decode_compact="on" if q8 else "off", prompt_cache_mb=64,
                           cuda_graphs=False, device="cuda")
    leaves = [eng._ck, eng._cv, eng._pool_k, eng._pool_v]
    for t in leaves:
        _fill_random(t, g)
    if via_pool:  # two blocks of each such row from pool rows 0 and 1
        base = eng._phys.pool_base
        for r in via_pool:
            eng._phys.table[r, :2] = [base, base + 1]
        eng._phys._dirty = True
    tbl = eng._phys.device_table(dev) if via_pool else None
    eng._d_last.copy_(torch.randint(3, 250, (B,), generator=g, device=dev, dtype=torch.int32))
    eng._d_temp[active[1]] = 0.8  # one sampled row
    eng._d_topp[active[1]] = 0.9
    nact = len(active)
    Ba = pow2_bucket(nact, B, floor=min(8, B)) if q8 else B
    compact = Ba < B
    lens0 = torch.randint(60, S - 4 * K, (nact,), generator=g, device=dev).cpu().to(torch.int32)

    def packed(r):
        lens = torch.full((B,), S, dtype=torch.int32)
        if compact:
            ids = torch.full((Ba,), next(i for i in range(B) if i not in active),
                             dtype=torch.int32)
            ids[:nact] = torch.tensor(active)
            lens = torch.full((Ba,), S, dtype=torch.int32)
            lens[:nact] = lens0 + r * K
            return torch.cat([lens, ids, torch.tensor([r + 1])]).to(torch.int32).to(dev)
        lens[active] = lens0 + r * K
        return torch.cat([lens, torch.tensor([r + 1])]).to(torch.int32).to(dev)

    def tree_clone():
        out = []
        for t in leaves + [eng._d_last]:
            out.append({k: v.clone() for k, v in t.items()} if isinstance(t, dict) else t.clone())
        return out

    def restore(snap):
        for t, s in zip(leaves + [eng._d_last], snap):
            if isinstance(t, dict):
                for k in t:
                    t[k].copy_(s[k])
            else:
                t.copy_(s)

    def same(a, b):
        if isinstance(a, dict):
            return all(torch.equal(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    fn = functools.partial(eng._round_fn, compact=compact)
    start = tree_clone()
    eng._gen.manual_seed(11)
    eager = [fn(packed(r), tbl).clone() for r in range(3)]
    after_eager = tree_clone()
    restore(start)
    eng._gen.manual_seed(11)
    graphs = RoundGraphs(dev, eng._gen)
    key = (Ba, compact, bool(via_pool))
    got = [graphs.run(key, fn, (packed(0), tbl)).clone()]
    P.reset_launches()
    got += [graphs.run(key, fn, (packed(r), tbl)).clone() for r in (1, 2)]
    torch.cuda.synchronize()
    launches = dict(P.LAUNCHES)
    tally = graphs.tally(key)
    for r in range(3):
        assert torch.equal(got[r], eager[r]), (case, r)
    assert all(same(a, b) for a, b in zip(tree_clone(), after_eager)), case
    assert graphs.replays == 2
    decode = "decode_attend_q8_mla" if kind == "mla" else (
        "decode_attend_q8" if q8 else "decode_attend_bf16")
    decode += "_paged" if via_pool else ""
    assert tally[decode] == K * eng.cfg.n_layers, tally
    assert launches == {n: 2 * tally.get(n, 0) for n in launches}, (launches, tally)
    eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "mla"])
def test_cuda_engine_capture_on_matches_off(kind):
    """Two engines on one parameter tree, rounds captured and eager, serve
    the same four requests (three greedy, one sampled at one seed), all
    queued before the loop starts so both admit and dispatch alike at
    pipeline depth 2: every request's tokens, and the cache afterwards,
    bit for bit; the captured engine replayed its rounds."""
    _card(950)  # skips without a card
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    cfg = _graph_cfg("mla" if kind == "mla" else "llm")
    q8 = kind != "bf16"
    kw = dict(max_slots=16 if q8 else 4, max_seq_len=512, seed=3,
              quant="int8" if q8 else "", kv_quant="int8" if q8 else "", device="cuda")
    prompts = [("user: hello there", 0.0), ("user: name three colours", 0.0),
               ("system: terse\nuser: 2+2?", 0.8), ("user: count to five", 0.0)]
    runs, params = [], None
    for graphs in (True, False):
        eng = GenerationEngine(cfg, params=params, cuda_graphs=graphs, **kw)
        params = eng.params
        assert eng.pipeline_depth == 2 and eng.cuda_graphs == graphs
        seen: dict = {}
        orig = eng._process_token

        def rec(s, tok, pos, seen=seen, orig=orig):
            seen.setdefault(s.req.request_id, []).append(int(tok))
            return orig(s, tok, pos)

        eng._process_token = rec
        reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=16, temperature=t,
                           top_p=0.9 if t else 1.0) for p, t in prompts]
        for r in reqs:
            eng.submit(r)
        eng.start()
        for r in reqs:
            while True:
                evt = r.out.get(timeout=300)
                if not isinstance(evt, dict) or evt["type"] in ("done", "error"):
                    assert isinstance(evt, dict) and evt["type"] == "done", evt
                    break
        eng.shutdown()
        torch.cuda.synchronize()
        cache = [{k: v.clone() for k, v in t.items()} if isinstance(t, dict) else t.clone()
                 for t in (eng._ck, eng._cv)]
        runs.append(([seen[r.request_id] for r in reqs], cache,
                     eng._graphs.replays if graphs else 0))
        del eng
    (t_on, c_on, replays), (t_off, c_off, _) = runs
    assert replays > 0
    assert t_on == t_off
    for a, b in zip(c_on, c_off):
        assert all(torch.equal(a[k], b[k]) for k in a) if isinstance(a, dict) \
            else torch.equal(a, b)


def _drive_by_hand(eng, lows, hi=None, fill=0, limit=4000):
    """The engine loop stepped by hand (`_step`, as its thread would): the
    `lows` queued, then, once `fill` slots decode, `hi`; until every request
    has ended. Returns each request's token ids, in submission order."""
    seen: dict = {}
    process = eng._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return process(s, tok, pos)

    eng._process_token = rec
    reqs, ended = list(lows), set()

    def collect():
        for r in reqs:
            while not r.out.empty():
                evt = r.out.get_nowait()
                if isinstance(evt, dict) and evt["type"] in ("done", "error"):
                    assert evt["type"] == "done", evt
                    ended.add(r.request_id)

    with torch.inference_mode():
        for r in lows:
            eng.submit(r)
        if hi is not None:
            for _ in range(limit):
                eng._step()
                if sum(s is not None for s in eng._slots) >= fill:
                    break
            assert sum(s is not None for s in eng._slots) >= fill
            eng._step()
            eng.submit(hi)
            reqs.append(hi)
        for _ in range(limit):
            collect()
            if len(ended) == len(reqs):
                break
            eng._step()
        eng._drain()
        collect()
    eng._process_token = process
    assert len(ended) == len(reqs)
    return [seen.get(r.request_id, []) for r in reqs]


def _round_buffers(eng) -> dict:
    """Storage address of every buffer a captured round reads."""
    out = {}
    for name in ("_ck", "_cv", "_pool_k", "_pool_v", "_d_last", "_d_temp", "_d_topk", "_d_topp"):
        t = getattr(eng, name)
        if t is not None:
            for k, x in (t.items() if isinstance(t, dict) else [("", t)]):
                out[name + k] = x.data_ptr()
    return out


# name: (config, max_slots, int8 weights and cache, prefix cache and a hit)
PREEMPT_CASES = {
    "bf16": ("llm", 2, False, False),
    "int8": ("llm", 16, True, False),
    "paged_hit": ("llm", 2, False, True),
    "mla_int8": ("mla", 2, True, False),
}
SHARED_PROMPT = "system: You are a careful assistant. Answer in one short line, please.\n"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREEMPT_CASES))
def test_cuda_preempt_restore_captured_matches_eager(monkeypatch, case):
    """A preempt -> host offload -> restore cycle at head_dim 128 (bf16,
    int8 with compacted rounds, a victim admitted off a physical prefix
    hit whose snapshot is private-only, MLA int8 latents), the loop stepped
    by hand at pipeline depth 2: with rounds captured and eager, every
    request's tokens, the caches, the prefix pool and the token ring bit
    for bit; every buffer a captured round reads keeps its storage across
    the cycle; the captured engine's contended tokens equal its
    uncontended ones; the ledger is clean and the packed scales sound."""
    _card(960)  # skips without a card
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", "1")
    # contended tokens are held to uncontended ones: with speculation on
    # they depend on where the verify rounds fall, which contention moves
    monkeypatch.setenv("TPU_SPEC", "0")
    kind, B, q8, hit = PREEMPT_CASES[case]
    cfg = _graph_cfg(kind)
    kw = dict(max_slots=B, max_seq_len=512, seed=3, quant="int8" if q8 else "",
              kv_quant="int8" if q8 else "", prompt_cache_mb=64 if hit else 0, device="cuda")
    head = SHARED_PROMPT if hit else ""
    lows = [(head + f"user: stream {i} says hello", 48 if i == 0 else 16 + 4 * (i % 5),
             0 if i == 0 else 1) for i in range(B)]
    runs, params = [], None
    for graphs in (True, False):
        eng = GenerationEngine(cfg, params=params, cuda_graphs=graphs, **kw)
        params = eng.params
        assert eng.pipeline_depth == 2 and eng._pool is not None

        def mk(cases, eng=eng):
            return [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=n,
                               temperature=0.0, priority=pri) for p, n, pri in cases]

        if hit:  # the second prompt stores the shared prefix, which the lows hit
            _drive_by_hand(eng, mk([(head + "user: prime one", 4, 0),
                                    (head + "user: prime two", 4, 0)]))
        ptrs = _round_buffers(eng)
        snaps = []
        offload = eng._pool.offload

        def rec(snap, seconds=0.0, offload=offload, snaps=snaps):
            snaps.append((snap.shared_len, snap.length, snap.k_rows["q"].shape[3]
                          if isinstance(snap.k_rows, dict) else snap.k_rows.shape[3]))
            offload(snap, seconds)

        eng._pool.offload = rec
        (hi,) = mk([("user: urgent request", 6, 5)])
        toks = _drive_by_hand(eng, mk(lows), hi, B)
        torch.cuda.synchronize()
        st, pg = eng.memory_stats(), eng.paging_stats()
        assert st["preempted_total"] >= 1 and st["restored_total"] >= 1, st
        assert st["preempted_held"] == 0.0
        assert pg["leaks"] == 0 and pg["slot_tables"] == 0 and pg["snap_parked"] == 0
        assert eng.kv_scale_audit() == 0
        if hit:
            assert all(s > 0 and rows == n - s for s, n, rows in snaps), snaps
        assert _round_buffers(eng) == ptrs
        state = [{k: v.clone() for k, v in t.items()} if isinstance(t, dict) else t.clone()
                 for t in (eng._ck, eng._cv, eng._pool_k, eng._pool_v, eng._d_last)
                 if t is not None]
        if graphs:
            assert eng._graphs.replays > 0
            ref = _drive_by_hand(eng, mk(lows))  # uncontended
            assert toks[:-1] == ref
        runs.append((toks, state))
        eng.shutdown()
        del eng
    (t_on, s_on), (t_off, s_off) = runs
    assert t_on == t_off
    for a, b in zip(s_on, s_off):
        assert all(torch.equal(a[k], b[k]) for k in a) if isinstance(a, dict) \
            else torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_engine_memory_released_after_shutdown(monkeypatch):
    """An engine that served a preempt -> restore cycle on captured rounds
    (prefix pool on, int8 cache) leaves nothing on the card once shut down
    and dropped: `memory_allocated()` returns to within 64 MiB of its value
    before the engine was built (cuBLAS keeps a workspace for the engine's
    capture stream)."""
    import gc

    dev, _, _, _ = _card(961)
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", "1")
    a = torch.randn(64, 64, device=dev)
    (a @ a).sum().item()  # the current stream's cuBLAS workspace exists already
    del a
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    eng = GenerationEngine(_graph_cfg("llm"), max_slots=2, max_seq_len=512, seed=3,
                           quant="int8", kv_quant="int8", prompt_cache_mb=64, device="cuda")
    built = torch.cuda.memory_allocated()
    lows = [GenRequest(prompt_ids=eng.tokenizer.encode(f"user: stream {i}"), max_tokens=24,
                       temperature=0.0, priority=0) for i in range(2)]
    hi = GenRequest(prompt_ids=eng.tokenizer.encode("user: urgent"), max_tokens=4,
                    temperature=0.0, priority=5)
    _drive_by_hand(eng, lows, hi, 2)
    assert eng.memory_stats()["restored_total"] >= 1 and eng._graphs.replays > 0
    eng.shutdown()
    del eng, lows, hi
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    assert built - base > 64 << 20
    assert after - base <= 64 << 20, (base, built, after)


SPEC_PROMPTS = ("repeat this exact list again and again: alpha beta gamma delta "
                "alpha beta gamma delta alpha beta gamma delta",
                "count with me: one two three, one two three, one two three")


def _step_logits_both_paths(cfg, params, seq, quantized):
    """The logits after `seq` from a decode step (the decode kernels) and
    from a one-token chunk pass (`llama_prefill_chunk_batch`, the verify
    round's arithmetic), both on one fresh cache holding seq[:-1]."""
    from llm_mcp_tpu_torch.models import llama as TL

    n = len(seq)
    cache = TL.init_kv_cache(cfg, 1, 512, dtype=torch.bfloat16, device="cuda",
                             quantized=quantized)
    ck, cv = cache["k"], cache["v"]
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device="cuda")

    def each(fn, *trees):
        return ({k: fn(*(t[k] for t in trees)) for k in trees[0]} if isinstance(trees[0], dict)
                else fn(*trees))

    with torch.inference_mode():
        _, ks, vs = TL.llama_prefill(cfg, params, i32([seq[:-1]]), i32([n - 1]),
                                     quant_kv=quantized)
        for c, k in ((ck, ks), (cv, vs)):
            each(lambda a, b: a[:, :, :, : n - 1].copy_(b), c, k)
        z_chunk, _, _ = TL.llama_prefill_chunk_batch(
            cfg, params, each(torch.clone, ck), each(torch.clone, cv), i32([[seq[-1]]]),
            i32([0]), i32([n - 1]), i32([1]), all_logits=True)
        z_dec, _, _ = TL.llama_decode_step(cfg, params, ck, cv, i32([seq[-1]]), i32([n - 1]))
    return z_dec[0].float(), z_chunk[0, 0].float()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_cuda_engine_spec_on_matches_off(monkeypatch, kind):
    """Two engines on one parameter tree, `TPU_SPEC` on and off, serve two
    greedy requests with repetitive prompts, driven by hand: the verify
    rounds ran on the card and accepted drafts, and each request's tokens
    are identical both ways or part at a near tie: where they part, a
    decode step and a chunk pass on one fresh cache both rank the two
    tokens as their best two among the ids the engine may sample, and the
    two tokens' logits lie within the paths' largest disagreement on that
    step (the verify's chunk arithmetic and the decode kernels round
    differently)."""
    _card(960)  # skips without a card
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    q8 = kind == "int8"
    kw = dict(max_slots=2, max_seq_len=512, seed=3, quant="int8" if q8 else "",
              kv_quant="int8" if q8 else "", device="cuda")
    cfg = _graph_cfg("llm")
    runs, params, prompts = [], None, None
    for spec in ("1", "0"):
        monkeypatch.setenv("TPU_SPEC", spec)
        eng = GenerationEngine(cfg, params=params, **kw)
        params = eng.params
        reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=48, temperature=0.0)
                for p in SPEC_PROMPTS]
        prompts = [r.prompt_ids for r in reqs]
        banned = eng._banned  # ids the engine never samples
        runs.append((_drive_by_hand(eng, reqs), eng.speculation_stats()))
        eng.shutdown()
        del eng
    (on, st), (off, st_off) = runs
    assert st["verify_calls"] > 0 and st["accepted_tokens"] > 0
    assert st_off["verify_calls"] == 0
    for ids, a, b in zip(prompts, off, on):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        assert i > 0  # the first token comes from the admission prefill, either way
        z_dec, z_chunk = (z if banned is None else z.masked_fill(banned, -1e9) for z in
                          _step_logits_both_paths(cfg, params, ids + a[:i], q8))
        for z in (z_dec, z_chunk):
            assert set(z.topk(2).indices.tolist()) == {a[i], b[i]}
        assert abs(float(z_dec[a[i]] - z_dec[b[i]])) <= float((z_dec - z_chunk).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_cuda_masked_step_launches_decode_kernel(monkeypatch, kind):
    """Constrained requests on the card: with `TPU_SPEC=0` every token comes
    from a masked single step, and each step launches the decode kernel
    once a layer; with it on, masked verify rounds run and the tokens are
    the same. The texts match their grammar."""
    _card(961)
    import re

    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    q8 = kind == "int8"
    kw = dict(max_slots=2, max_seq_len=512, seed=3, quant="int8" if q8 else "",
              kv_quant="int8" if q8 else "", device="cuda")
    kernel = "decode_attend_q8" if q8 else "decode_attend_bf16"
    pattern = "(alpha beta gamma delta ){3}done"
    runs, params = [], None
    for spec in ("0", "1"):
        monkeypatch.setenv("TPU_SPEC", spec)
        eng = GenerationEngine(_graph_cfg("llm"), params=params, **kw)
        params = eng.params
        steps = []
        cn_step = eng._cn_step_round

        def counted(active, cn_step=cn_step, steps=steps):
            before = P.LAUNCHES[kernel]
            cn_step(active)
            steps.append(P.LAUNCHES[kernel] - before)

        eng._cn_step_round = counted
        reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=96, temperature=0.0,
                           constraint={"type": "regex", "pattern": pattern})
                for p in ("say it", "say it again")]
        toks = _drive_by_hand(eng, reqs)
        text = [eng.tokenizer.decode(t) for t in toks]
        runs.append((toks, steps, eng.cn_spec_drafted, eng.constrain_stats()))
        assert all(re.fullmatch(pattern, t) for t in text), text
        eng.shutdown()
        del eng
    (t_off, steps_off, _, st_off), (t_on, _, drafted, st_on) = runs
    L = _graph_cfg("llm").n_layers
    assert steps_off and all(n == L for n in steps_off)
    assert drafted > 0 and t_on == t_off
    assert st_off["illegal_tokens"] == st_on["illegal_tokens"] == 0.0


# the head_dim-256 flash kernel's cases: (S, window, H, Hkv, lengths);
# Gemma-2-9B's heads (16 over 8) unless a case says otherwise
HD256_CASES = {
    "S67": (67, 0, 16, 8, [67, 0]),  # S not a multiple of 64; a row of length 0
    "S640_w200": (640, 200, 16, 8, [640, 0]),  # a window of three tiles
    "S1100": (1100, 0, 16, 8, [1095]),
    "S4500_w4096": (4500, 4096, 16, 8, [4495]),  # a window longer than most rows
    "admission": (512, 0, 16, 8, [512, 400, 300, 200]),  # 4 prompts in a 512 bucket
    "S8192_sliding": (8192, 4096, 16, 8, [8192]),  # a whole-prompt admission
    "G1": (300, 0, 8, 8, [300, 129]),  # one head a KV head: two query tiles a CTA
    "G3": (333, 100, 12, 4, [333, 65]),  # odd G: the same, over three heads a KV head
    # lengths straddling the 64-row tiles and the 128-row pairs of odd G
    "edges": (260, 0, 16, 8, [63, 64, 65, 127, 128, 129, 1, 0]),
    "edges_G1": (260, 0, 4, 4, [63, 64, 65, 127, 128, 129, 1, 0]),
    "window1": (200, 1, 16, 8, [200, 77]),  # each row its own key alone
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HD256_CASES))
def test_cuda_flash_prefill_hd256(case):
    """The head_dim-256 flash kernel (a TMA producer warp, two consumer
    warpgroups on different query rows) with Gemma-2's softcap 50 and scale
    224**-0.5 against its plain version, |err| <= 1e-3 + 1e-2*|ref|: S not a
    multiple of 64, windows of 1 key, three tiles and past S, rows of length
    0 (they emit 0), lengths on and beside the 64- and 128-row edges, G = 1,
    2 and 3 (the odd-G mapping), Gemma-2's admission shape and a whole
    8192-token prompt. 20 more calls each equal the first bit for bit, and
    every launch counts under the kernel's own name."""
    S, window, H, Hkv, lens = HD256_CASES[case]
    _, _, rn, i32 = _card(900 + S + H)
    B, hd = len(lens), 256
    q, k, v = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    ln = i32(lens)
    before = P.LAUNCHES["flash_prefill_attention_hd256"]
    kw = dict(window=window, softcap=50.0, scale=224.0**-0.5)
    out = P.flash_prefill_attention(q, k, v, ln, **kw)
    ref = P.flash_prefill_plain(q, k, v, ln, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    for b, n in enumerate(lens):
        if n == 0:
            assert not out[b].any()
    for _ in range(20):
        assert torch.equal(P.flash_prefill_attention(q, k, v, ln, **kw), out)
    assert P.LAUNCHES["flash_prefill_attention_hd256"] == before + 21
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [6, 7])
@pytest.mark.parametrize("arm", ["bf16", "q8"])
def test_cuda_decode_g_not_dividing_64_paged(G, arm):
    """The decode kernels at G = 6 and 7 (R1-Distill-Qwen-1.5B's and
    Qwen2.5-7B's query heads a KV head) through block tables: pool rows,
    a foreign arena home, a parked row; bf16 and the fused int8 cache."""
    dev, g, rn, i32 = _card(950 + G + (arm == "q8"))
    L, B, Hkv, S, hd, pxb, bt = 2, 4, 4, 1024, 128, 5, 64
    nbs = S // bt
    tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
    for b in range(B):
        tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
    tbl[1, 3] = 2 * nbs + 3
    tbl = tbl.to(dev)
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens, ids = i32([5, 3 * bt + 7, S - 1, S]), i32([1, 3, 0, 2])
    if arm == "q8":
        cache = _fused_cache(g, dev, L, B, Hkv, S, hd)
        pool = _fused_cache(g, dev, L, pxb, Hkv, bt, hd)
        out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, slot_ids=ids, scale=0.09,
                                 block_tables=tbl, pool_k=pool)
        ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, bt, tbl, pool)
    else:
        ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
        pk, pv = rn(L, pxb, Hkv, bt, hd), rn(L, pxb, Hkv, bt, hd)
        out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, slot_ids=ids, scale=0.09,
                                   block_tables=tbl, pool_k=pk, pool_v=pv)
        ref = P.decode_attend_paged_plain(q, nk, nv, ck, cv, 1, lens, tbl, pk, pv, ids, 0.09)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


# -- the head_dim-64 arms (Llama-3.2-1B: G = 4; Qwen2.5-0.5B: G = 7) ---------


@pytest.mark.cuda
@pytest.mark.parametrize("S", [67, 640])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
def test_cuda_flash_prefill_hd64(S, G):
    """The head_dim-64 flash arm (one warpgroup, one 64-column block, P.V
    on m64n64k16) at the tile's edges: S not a multiple of 64, every G of
    the catalog at 64 and the tile's, a row of length 0 (emits 0), a
    length inside a tile, a sliding window, softcap with a scale; repeats
    bit for bit; the launch counts under its own name."""
    _, _, rn, i32 = _card(1500 + S + G)
    B, Hkv, hd = 3, 2, 64
    H = Hkv * G
    q, k, v = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    ln = i32([S, 0, S // 2 + 3])
    before = P.LAUNCHES["flash_prefill_attention_hd64"]
    for kw in (dict(), dict(window=37), dict(softcap=20.0, scale=0.05)):
        out = P.flash_prefill_attention(q, k, v, ln, **kw)
        ref = P.flash_prefill_plain(q, k, v, ln, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
        assert not out[1].any()
        assert torch.equal(out, P.flash_prefill_attention(q, k, v, ln, **kw))
    assert P.LAUNCHES["flash_prefill_attention_hd64"] == before + 6
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("arm", ["bf16", "q8"])
@pytest.mark.parametrize("bt", [0, 32, 64, 128])
def test_cuda_ragged_prefill_hd64(G, arm, bt):
    """`test_cuda_ragged_prefill_tile_edges` on the head_dim-64 tile (the
    int8 staging ring of 64-byte rows): CTAs straddling descriptor rows, a
    pad tail, prefixes ending inside a 64-key tile, contiguous and through
    tables with pool rows and a foreign home; bf16 and int8 caches;
    repeats bit for bit."""
    _ragged_tile_case(G, arm, bt, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("bt", [0, 32, 64, 128, 256])
def test_cuda_decode_bf16_hd64(monkeypatch, bt, G, chunk):
    """The head_dim-64 bf16 decode kernel (8 lanes a row, four lane groups
    a warp, 64-key stages, two shuffle rounds of merge, a 64-thread
    combine) against its plain version at every edge: w = 0, a lane-group
    and stage edge (63, 64), a split edge (chunk - 1, chunk), S - 1 and a
    parked row; contiguous and through tables (pool rows in shuffled
    order, a foreign arena home) at every block size."""
    dev, _, rn, i32 = _card(1700 + bt + 10 * G + chunk)
    monkeypatch.setattr(P, "DECODE_CHUNK_BF16", chunk)
    L, B, Hkv, S, hd, pxb = 2, 8, 2, 1024, 64, 5
    q, nk, nv, ck, cv = _decode_case(rn, i32, L, B, Hkv, G, S, hd)
    lens = i32([0, 63, 64, chunk - 1, chunk, 2 * chunk + 17, S - 1, S])
    ids = i32([5, 2, 7, 0, 3, 6, 1, 4])
    kw, name = dict(slot_ids=ids, scale=0.09), "decode_attend_bf16_hd64"
    if bt:
        nbs = S // bt
        pk, pv = rn(L, pxb, Hkv, bt, hd), rn(L, pxb, Hkv, bt, hd)
        tbl = torch.arange(B * nbs, dtype=torch.int32).reshape(B, nbs)
        for b in range(B):
            tbl[b, :3] = B * nbs + torch.tensor([(b + j) % pxb for j in range(3)])
        tbl[2, 3] = 4 * nbs + 3
        tbl = tbl.to(dev)
        kw.update(block_tables=tbl, pool_k=pk, pool_v=pv)
        ref = P.decode_attend_paged_plain(q, nk, nv, ck, cv, 1, lens, tbl, pk, pv, ids, 0.09)
        name = "decode_attend_bf16_paged_hd64"
    else:
        ref = P.decode_attend_plain(q, nk, nv, ck, cv, 1, lens, ids, 0.09)
    before = P.LAUNCHES[name]
    out = P.decode_attend_bf16(q, nk, nv, ck, cv, 1, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    assert P.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_cuda_decode_attention_hd64(monkeypatch, G, chunk):
    """The post-append arm at head_dim 64: lengths -1 (the mean of V over
    S), 0, the stage and split edges, mid-row, S - 1 and >= S."""
    _, _, rn, i32 = _card(1800 + G + chunk)
    monkeypatch.setattr(P, "DECODE_CHUNK_BF16", chunk)
    B, Hkv, S, hd = 10, 2, 1000, 64
    q, ck, cv = rn(B, Hkv, G, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    lens = i32([-1, 0, 63, 64, chunk - 1, chunk, 500, S - 1, S, S + 3])
    out = P.decode_attention(q, ck, cv, lens)
    ref = P.decode_attention_plain(q, ck, cv, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    torch.cuda.synchronize()


def _q8_tie_allowance(q, nk, cache, lens, ids, scale, group, tbl=None, pool=None):
    """Per output element of the int8 decode, what one p8 step at each key
    on a rounding tie would move it: the keys whose p * vss / psc lies
    within 1e-4 of k + 1/2 in float64 (the plain version's arithmetic: the
    group's psc, p against the row max), each adding psc * |v8| / l in
    every dim. On such a tie the kernel (fast exp, p through its split's
    max, a reciprocal multiply) and the plain version (exact exp, one
    division) may round p8 apart by one step. Zero where no key sits on a
    tie, and for the exact arm (group 0), which does not requantize."""
    from llm_mcp_tpu_torch.models.quant import INV127

    Ba, Hkv, G, hd = q.shape
    allow = torch.zeros(q.shape, dtype=torch.float64, device=q.device)
    if not group:
        return allow
    pay, ss = P._q8_rows(cache, 1, ids.long(), tbl, pool)
    S = pay.shape[2]
    for b in range(Ba):
        w = int(lens[b])
        if not 0 <= w < S:
            continue
        for h in range(Hkv):
            k8, v8 = pay[b, h].double(), pay[b, Hkv + h].double()
            kss, vss = ss[b, h].double(), ss[b, Hkv + h].double()
            for g in range(G):
                qf = q[b, h, g].double()
                qsc = max(float(qf.abs().max()) * INV127, 1e-30)
                sc = (k8 @ torch.round(qf / qsc)) * (scale * qsc) * kss
                sc[w] = float(qf @ nk[b, h].double()) * scale
                sc[w + 1:] = -torch.inf
                p = torch.exp(sc - sc[: w + 1].max())
                pv = p * vss
                pv[w] = 0.0
                psc = (pv.reshape(S // group, group).amax(1) * INV127).clamp(min=1e-30)
                psc = psc.repeat_interleave(group)
                r = pv / psc
                tie = ((r - r.floor() - 0.5).abs() < 1e-4) & (pv > 0)
                allow[b, h, g] = (psc[tie, None] * v8[tie].abs()).sum(0) / p.sum()
    return allow


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case,G", [(c, G) for c in ("g256", "g32", "row", "bt32", "bt64", "bt256")
                                    for G in (1, 4, 7, 8)] + [("exact", 1)])
def test_cuda_q8_decode_hd64(case, G, packed):
    """The head_dim-64 int8 decode kernel (2 KB slots, two rows a swizzle
    line, 2 s8 k-steps) against its plain version with the same group:
    256 (S = 1024) and 32 (S = 608) contiguous, the whole row (S = 1000),
    the exact arm (S = 4072 past the whole-S budget at 16 KV heads), and
    through tables at 32-, 64- and 256-token blocks (pool rows, foreign
    homes, scrambled arena); w at 0, stage, warp and split edges, S - 1
    and parked; two calls agree bit for bit. |err| <= 1e-3 + 1e-2*|ref|,
    plus one p8 step at each key whose p8 sits on a rounding tie
    (`_q8_tie_allowance`; the whole row's one scale over 1000 keys makes
    small p8 and such ties likely: at G = 1 with plain scales a key on
    exactly 2.5 steps moved 13 outputs of one head by one step)."""
    dev, g, rn, i32 = _card(1900 + 10 * G + packed + 3 * len(case))
    L, B, hd = 2, 11, 64
    Hkv = 16 if case == "exact" else 2
    S = {"g256": 1024, "g32": 608, "row": 1000, "exact": 4072}.get(case, 1024)
    bt = int(case[2:]) if case.startswith("bt") else 0
    lens = i32([0, 31, 32, 63, 64, 255, 256, 257, 700, S - 1, S])
    ids = i32([5, 2, 7, 0, 3, 6, 1, 4, 10, 9, 8])
    q, nk, nv = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    kw, tbl, pool = dict(slot_ids=ids, scale=0.09), None, None
    if bt:
        cache, pool, tbl, _ = _q8_paged_case(g, dev, L, B, Hkv, S, hd, bt, packed)
        kw.update(block_tables=tbl, pool_k=pool)
    else:
        cache = _fused_cache(g, dev, L, B, Hkv, S, hd, packed)
    group = P.q8_decode_plan(S, hd, Hkv, Hkv * G, S // bt if bt else None)[0]
    assert group == {"g256": 256, "g32": 32, "row": S, "exact": 0}.get(case, bt)
    out = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, **kw)
    again = P.decode_attend_q8(q, nk, nv, cache, {}, 1, lens, **kw)
    ref = P.decode_attend_q8_plain(q, nk, nv, cache, 1, lens, ids, 0.09, group, tbl, pool)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    allow = _q8_tie_allowance(q, nk, cache, lens, ids, 0.09, group, tbl, pool)
    err = (out.double() - ref.double()).abs()
    limit = 1e-3 + 1e-2 * ref.double().abs() + allow
    assert (err <= limit).all(), (err - limit).max()
    torch.testing.assert_close(out[10], nv[10][:, None].expand(Hkv, G, hd), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arm,packed", FUSED_APPEND_ARMS)
def test_cuda_decode_fused_append_hd64(arm, packed):
    """`test_cuda_decode_fused_append` at head_dim 64: every decode arm's
    append bit for bit, the 64-byte packed-scale row with its zero tail
    included (the standalone int8 append is built for 128: its plain
    version stands in)."""
    _fused_append_case(arm, packed, 64)



@pytest.mark.cuda
@pytest.mark.parametrize("S,B", [(32, 64), (4096, 8)])
def test_cuda_flash_prefill_embedding_buckets(S, B):
    """The flash kernel at the embedding engine's edge buckets, 32/8 heads
    (Qwen3-Embedding-8B): S = 32, under one 64-row query tile, with a batch
    of 64, and S = 4096 with 8 rows; most rows are the engine's pad rows of
    length 1. Against `flash_prefill_plain` one row at a time; a second
    call equal bit for bit."""
    dev, g, rn, i32 = _card(2100 + S)
    H, Hkv, hd = 32, 8, 128
    head = [S, S - 1, S // 2 + 1, 1, 17, 2, 64 if S > 64 else 31, 1]
    lens = i32(head + [1] * (B - len(head)))
    q, k, v = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    out = P.flash_prefill_attention(q, k, v, lens)
    again = P.flash_prefill_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    for b in range(B):
        ref = P.flash_prefill_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], lens[b:b + 1])
        torch.testing.assert_close(out[b:b + 1].float(), ref.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["qwen3-embedding-8b", "nomic-embed-text"])
def test_cuda_embedding_matches_host(model):
    """Two layers of each embedder at its published widths, random bf16
    weights on the card, against the same functions on the host in f32
    (the plain versions): cosine >= 0.9995 per vector. The decoder
    embedder launches the flash kernel once a layer, the encoder never.
    Then an engine over the same weights: one input alone agrees with the
    same input inside a padded batch (cosine >= 0.999)."""
    import dataclasses

    from llm_mcp_tpu_torch.executor import EmbeddingEngine
    from llm_mcp_tpu_torch.models import embedder as TE
    from llm_mcp_tpu_torch.models import llama as TL
    from llm_mcp_tpu_torch.models.configs import get_config

    dev, g, _, i32 = _card(2200)
    cfg = dataclasses.replace(get_config(model), n_layers=2)
    decoder = cfg.arch != "encoder"
    init = TL.init_llama_params if decoder else TE.init_embedder_params
    fwd = TL.llama_encode if decoder else TE.embed_forward
    params = init(cfg, g, torch.bfloat16, device=dev)
    host = {k: ({n: t.float().cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.float().cpu()) for k, v in params.items()}
    tokens = torch.randint(3, cfg.vocab_size, (4, 64), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    lens = [64, 33, 1, 50]
    before = P.LAUNCHES["flash_prefill_attention"]
    got = fwd(cfg, params, tokens.to(dev), i32(lens))
    torch.cuda.synchronize()
    assert P.LAUNCHES["flash_prefill_attention"] - before == (2 if decoder else 0)
    want = fwd(cfg, host, tokens, torch.tensor(lens, dtype=torch.int32))
    cos = torch.nn.functional.cosine_similarity(got.cpu(), want, dim=-1)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert cos.min().item() >= 0.9995, cos
    eng = EmbeddingEngine(cfg, params=params, max_batch=8, max_seq_len=256, device=dev)
    texts = ["alone " * 20, "a", "bb " * 70, "ccc", "dd"]
    one, _ = eng.embed(texts[:1])
    many, _ = eng.embed(texts)
    c = torch.nn.functional.cosine_similarity(torch.tensor(one[0]), torch.tensor(many[0]), dim=0)
    assert c.item() >= 0.999, c
