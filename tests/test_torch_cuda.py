"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU. The file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from llm_mcp_tpu_torch.kernels import attention as P


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the same bf16 inputs
    (small shapes, head_dim 128), element by element within
    |err| <= 1e-3 + 1e-2*|ref|: both sides accumulate in f32 and round the
    output to bf16 once, so they may differ by one bf16 step (at most 2^-7
    relative); append is bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

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
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(bt)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

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
