"""Attention kernels of the serving path (counterpart of
`llm_mcp_tpu/kernels/attention.py`).

Twenty-nine CUDA C++ entry points for `sm_90a`, sources in `csrc/`:

  - `append_kv_bf16`             ← `_append_bf16_kernel`
  - `decode_attend_bf16`         ← `_attend_bf16_kernel` + `_attend_bf16_blocked_kernel`
  - `decode_attend_bf16_paged`   ← `_attend_bf16_paged_kernel`
  - `decode_attention`           ← `_decode_attn_kernel` (post-append, on no
                                   served path)
  - `flash_prefill_attention`    ← `_flash_prefill_kernel` (head_dim 128)
  - `flash_prefill_attention_hd256` ← `_flash_prefill_kernel` at head_dim
                                   256 (Gemma-2; `flash_prefill_hd256.cu`,
                                   a kernel of its own; the same wrapper)
  - `ragged_prefill_attend_bf16` ← `_ragged_prefill_bf16_kernel`, identity tables
  - `ragged_prefill_attend_bf16_paged` ← the same body's block-table path
  - `append_kv_q8`               ← `_append_q8_kernel` with the quantization
                                   and scale packing of `append_kv_q8`
  - `decode_attend_q8`           ← `_attend_q8_kernel` + `_attend_q8_blocked_kernel`
  - `decode_attend_q8_paged`     ← `_attend_q8_paged_kernel`
  - `ragged_prefill_attend_q8`   ← `_ragged_prefill_q8_kernel`, identity tables
  - `ragged_prefill_attend_q8_paged` ← the same body's block-table path
  - `decode_attend_q8_mla`       ← `_attend_q8_mla_kernel` + `_attend_q8_mla_blocked_kernel`
  - `decode_attend_q8_mla_paged` ← `_attend_q8_mla_paged_kernel`
  - `ragged_prefill_attend_mla`  ← `_ragged_prefill_mla_kernel`, bf16 or int8
                                   latents (`_q8`), identity or block tables
                                   (`_paged`): four entry points

Widths. The GQA kernels are built for head_dim 128 (the entry points
above) and 64 (Llama-3.2-1B, Qwen2.5-0.5B): the same wrappers launch
`flash_prefill_bf16_hd64` (`flash_prefill_hd64.cu`), the four ragged entry
points with `_hd64` (`ragged_prefill_hd64.cu`), and `decode_attend_bf16`,
`decode_attend_bf16_paged`, `decode_attention_bf16`, `decode_attend_q8`
and `decode_attend_q8_paged` with `_hd64` (`decode_attend_hd64.cu`, the
fused appends included); their launches count under the wrapper's name
with `_hd64` (`_arm`). Flash prefill also runs at 256. The standalone
appends and the MLA kernels are built for 128 (MLA: its own widths) only;
every wrapper raises on a width it has no arm for.

The flash and ragged prefill kernels (bf16 and int8) multiply on the
tensor cores (`wgmma`, `csrc/tile_attention.cuh`); at head_dim 256 the
flash kernel is one of its own, fed by a TMA producer warp, with two
consumer warpgroups on different query rows (`csrc/flash_prefill_hd256.cu`).
The MLA ragged prefill kernel multiplies on a tile of its own
(`csrc/ragged_prefill_mla.cu`).
The MLA int8 decode kernel takes all heads of a row and 128 of its keys a
CTA, on the int8 tensor cores (`mma.sync`, `csrc/decode_attend_mla.cu`);
the GQA int8 decode kernel a KV head of a row and 256 of its keys a CTA, on
the same instructions, its splits combined by the row's last CTA
(`csrc/decode_attend.cu`, `q8_decode_plan`); where the requantization group
is the whole row, a score pass launched ahead of it gives every split the
row's scale.

With `append=True` the bf16 and int8 decode wrappers also write the layer's
new K/V row into the cache, from inside the decode kernel (the CTA whose
split holds the row's position): the bytes `append_kv_bf16` /
`append_kv_q8` would write for that layer. The decode step appends so, one
layer at a time; the standalone appends stay for every other caller.

The paged kernels are what the decode and ragged wrappers launch when
given `block_tables` (the physical layout of `executor/physical.py`);
`paged_gather` is their plain versions' read side.

The int8 kernels read and write the fused int8 cache of
`models/llama.py:init_kv_cache(quantized=True)`: `{"q": int8 [L, B,
2*Hkv + p, S, hd], "s": [L, B, 2*Hkv, S]}`, K heads then V heads, and with
p = 1 a pseudo-head carrying the same scales bit-packed
(`models/quant.py:pack_scales`). The MLA kernels read the latent cache
of `models/mla.py` (described above their section).

Each wrapper keeps the JAX function's layouts and arguments. It takes its
plain PyTorch version (`*_plain`, beside it) only for tensors on the CPU;
for CUDA tensors it checks device, dtype, shape and contiguity, allocates
its outputs with `torch.empty`, launches its kernel on the current stream
and raises if the launch is refused. `LAUNCHES[name]` counts the launches
of each kernel, so a run can show that the main path went through it.

The caches are updated in place (the JAX functions return new arrays):
the appends, standalone or fused, write their rows into the tensors they
are given.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

NEG_INF = -1e30
HEAD_DIM = 128  # the head_dim of the standalone appends
HEAD_DIMS = (64, 128)  # the ragged and decode kernels' arms
FLASH_HEAD_DIMS = (64, 128, 256)  # the flash prefill kernel's arms
DECODE_CHUNK = 256  # key positions per int8 decode split: whole groups (q8_decode_plan)
# key positions per bf16 decode split; depends on S alone, so the wrappers
# never read lengths on the host (chosen by the sweep in chip_smoke.py)
DECODE_CHUNK_BF16 = 128
MAX_G = 8  # most query heads per KV head the decode kernel takes

# `*_fused`: decode launches that also appended (append=True);
# `decode_attend_q8_row`: int8 decode launches of the whole-row arm (its
# score pass and split kernel)
LAUNCHES: dict[str, int] = {
    "append_kv_bf16": 0,
    "append_kv_bf16_fused": 0,
    "decode_attend_bf16": 0,
    "decode_attend_bf16_paged": 0,
    "decode_attention": 0,
    "flash_prefill_attention": 0,
    "flash_prefill_attention_hd256": 0,
    "flash_prefill_attention_hd64": 0,
    "ragged_prefill_attend_bf16": 0,
    "ragged_prefill_attend_bf16_paged": 0,
    "append_kv_q8": 0,
    "append_kv_q8_fused": 0,
    "decode_attend_q8": 0,
    "decode_attend_q8_row": 0,
    "decode_attend_q8_paged": 0,
    "ragged_prefill_attend_q8": 0,
    "ragged_prefill_attend_q8_paged": 0,
    "decode_attend_q8_mla": 0,
    "decode_attend_q8_mla_paged": 0,
    "ragged_prefill_attend_mla": 0,
    "ragged_prefill_attend_mla_paged": 0,
    "ragged_prefill_attend_mla_q8": 0,
    "ragged_prefill_attend_mla_q8_paged": 0,
}
# the head_dim-64 arms count under the same names with `_hd64`
LAUNCHES.update({f"{n}_hd64": 0 for n in (
    "append_kv_bf16_fused", "decode_attend_bf16", "decode_attend_bf16_paged",
    "decode_attention", "ragged_prefill_attend_bf16", "ragged_prefill_attend_bf16_paged",
    "append_kv_q8_fused", "decode_attend_q8", "decode_attend_q8_row", "decode_attend_q8_paged",
    "ragged_prefill_attend_q8", "ragged_prefill_attend_q8_paged")})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "append_kv_bf16": ("append_kv", [_P] * 6 + [_I] * 6 + [_P]),
    "decode_attend_bf16": ("decode_attend", [_P] * 11 + [_I] * 9 + [_F, _I, _P]),
    "decode_attend_bf16_paged": ("decode_attend", [_P] * 14 + [_I] * 12 + [_F, _I, _P]),
    "decode_attention_bf16": ("decode_attend", [_P] * 8 + [_I] * 7 + [_F, _P]),
    "flash_prefill_bf16": ("flash_prefill", [_P] * 5 + [_I] * 6 + [_F, _F, _P]),
    "flash_prefill_bf16_hd256": ("flash_prefill_hd256", [_P] * 5 + [_I] * 6 + [_F, _F, _P]),
    "ragged_prefill_bf16": ("ragged_prefill", [_P] * 10 + [_I] * 8 + [_F, _P]),
    "ragged_prefill_bf16_paged": ("ragged_prefill", [_P] * 13 + [_I] * 11 + [_F, _P]),
    "append_kv_q8": ("append_kv_q8", [_P] * 6 + [_I] * 6 + [_P]),
    "decode_attend_q8": ("decode_attend", [_P] * 11 + [_I] * 11 + [_F, _P, _I, _P]),
    "decode_attend_q8_paged": ("decode_attend", [_P] * 14 + [_I] * 13 + [_F, _I, _P]),
    "ragged_prefill_q8": ("ragged_prefill", [_P] * 10 + [_I] * 9 + [_F, _P]),
    "ragged_prefill_q8_paged": ("ragged_prefill", [_P] * 13 + [_I] * 12 + [_F, _P]),
    "decode_attend_q8_mla": ("decode_attend_mla", [_P] * 12 + [_I] * 9 + [_F, _P]),
    "decode_attend_q8_mla_paged": ("decode_attend_mla", [_P] * 17 + [_I] * 12 + [_F, _P]),
    "ragged_prefill_mla": ("ragged_prefill_mla", [_P] * 11 + [_I] * 8 + [_F, _P]),
    "ragged_prefill_mla_paged": ("ragged_prefill_mla", [_P] * 14 + [_I] * 11 + [_F, _P]),
    "ragged_prefill_mla_q8": ("ragged_prefill_mla", [_P] * 13 + [_I] * 8 + [_F, _P]),
    "ragged_prefill_mla_q8_paged": ("ragged_prefill_mla", [_P] * 18 + [_I] * 11 + [_F, _P]),
}
# the head_dim-64 arms: the same signatures, from their own libraries
_SIGNATURES.update({
    "flash_prefill_bf16_hd64": ("flash_prefill_hd64", _SIGNATURES["flash_prefill_bf16"][1]),
    **{f"{n}_hd64": ("ragged_prefill_hd64", _SIGNATURES[n][1])
       for n in ("ragged_prefill_bf16", "ragged_prefill_bf16_paged", "ragged_prefill_q8",
                 "ragged_prefill_q8_paged")},
    **{f"{n}_hd64": ("decode_attend_hd64", _SIGNATURES[n][1])
       for n in ("decode_attend_bf16", "decode_attend_bf16_paged", "decode_attention_bf16",
                 "decode_attend_q8", "decode_attend_q8_paged")},
})


def _arm(name: str, hd: int) -> str:
    """The entry point or launch counter `name` at head_dim hd: the 128 arm
    bears the bare name, the others end in `_hd64` / `_hd256`."""
    return name if hd == 128 else f"{name}_hd{hd}"


_FNS: dict[str, ctypes._CFuncPtr] = {}


def _fn(symbol: str):
    f = _FNS.get(symbol)
    if f is None:
        source, argtypes = _SIGNATURES[symbol]
        f = getattr(build.load(source), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[symbol] = f
    return f


def _launch(name: str, symbol: str, *args) -> None:
    """Call the C entry point (tensors pass as their data pointers) on the
    current stream; count the launch, or raise if it was refused."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = _fn(symbol)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {rc}")
    LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _rows(slot_ids: torch.Tensor | None, n: int, device) -> torch.Tensor:
    if slot_ids is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return slot_ids


def paged_gather(arena, pool, tables, *, nbs=None):
    """Block-indirect gather (counterpart of JAX's `paged_gather`, plain
    indexing there too): the contiguous-equivalent rows of each table row.

    arena  [B, Hx, S, *rest]    layer-selected slot arena (identity homes)
    pool   [PXB, Hx, bt, *rest] layer-selected prefix pool
    tables [A, nsel] int        per-row block tables; a prefix of the full
        table may be passed, with `nbs` naming the full blocks per slot
    returns [A, Hx, nsel*bt, *rest]

    Ids below B*nbs read arena block (id % nbs) of row (id // nbs); the
    others read pool row (id - B*nbs). Out-of-range ids are clamped, as in
    JAX."""
    B, Hx, S = arena.shape[0], arena.shape[1], arena.shape[2]
    rest = tuple(arena.shape[3:])
    A, nsel = tables.shape
    nbs = nsel if nbs is None else nbs
    bt = S // nbs
    pool_base = B * nbs
    blk = arena.reshape(B, Hx, nbs, bt, *rest)
    t = tables.long()
    safe = t.clamp(0, pool_base - 1)
    # advanced indices at axes 0 and 2 (split by a slice) land in front:
    # [A, nsel, Hx, bt, *rest]
    arena_take = blk[safe // nbs, :, safe % nbs]
    pidx = (t - pool_base).clamp(0, max(pool.shape[0] - 1, 0))
    pool_take = pool[pidx]
    ina = (t < pool_base).reshape(A, nsel, *([1] * (arena_take.ndim - 2)))
    g = torch.where(ina, arena_take, pool_take)
    return g.transpose(1, 2).reshape(A, Hx, nsel * bt, *rest)


def _check_paged(name, block_tables, pool_k, pool_v, L, B, Hkv, S, hd, dev) -> tuple[int, int, int]:
    """Check the paged operands; returns (nbs, bt, pool rows)."""
    if block_tables.dim() != 2 or block_tables.shape[1] < 1 or S % block_tables.shape[1]:
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} must be "
                         f"[rows, nbs] with nbs dividing S={S}")
    nbs = block_tables.shape[1]
    bt = S // nbs
    if pool_k is None or pool_v is None:
        raise ValueError(f"{name}: block_tables need pool_k and pool_v")
    pxb = pool_k.shape[1] if pool_k.dim() == 5 else 0
    if pxb < 1:
        raise ValueError(f"{name}: the prefix pool needs at least one row")
    for t in (pool_k, pool_v):
        _check(name, t, torch.bfloat16, (L, pxb, Hkv, bt, hd), dev)
    _check(name, block_tables, torch.int32, (block_tables.shape[0], nbs), dev)
    return nbs, bt, pxb


# ---------------------------------------------------------------------------
# append_kv_bf16
# ---------------------------------------------------------------------------


def append_kv_plain(cache_k, cache_v, new_k, new_v, lengths, slot_ids=None):
    """Plain version: scatter row b's K/V (all layers) to position
    lengths[b] of cache row slot_ids[b], in place; rows with a position
    outside [0, S) write nothing."""
    S = cache_k.shape[3]
    rows = _rows(slot_ids, new_k.shape[1], cache_k.device).long()
    w = lengths.long()
    live = (w >= 0) & (w < S)
    b_idx, w_idx = rows[live], w[live]
    cache_k[:, b_idx, :, w_idx] = new_k[:, live].transpose(0, 1).to(cache_k.dtype)
    cache_v[:, b_idx, :, w_idx] = new_v[:, live].transpose(0, 1).to(cache_v.dtype)
    return cache_k, cache_v


def append_kv_bf16(
    cache_k: torch.Tensor,  # [L, B, Hkv, S, hd] — updated in place
    cache_v: torch.Tensor,
    new_k: torch.Tensor,  # [L, Ba, Hkv, hd] — this step's K, all layers
    new_v: torch.Tensor,
    lengths: torch.Tensor,  # [Ba] int32 — write position per row (>= S: skip)
    *,
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one decode step's K/V for all layers into the cache, in place.
    Returns the (same) cache tensors."""
    if cache_k.device.type == "cpu":
        return append_kv_plain(cache_k, cache_v, new_k, new_v, lengths, slot_ids)
    name = "append_kv_bf16"
    L, B, Hkv, S, hd = cache_k.shape
    Ba = new_k.shape[1]
    dev = cache_k.device
    rows = _rows(slot_ids, Ba, dev)
    for t in (cache_k, cache_v):
        _check(name, t, torch.bfloat16, (L, B, Hkv, S, hd), dev)
    for t in (new_k, new_v):
        _check(name, t, torch.bfloat16, (L, Ba, Hkv, hd), dev)
    for t in (lengths, rows):
        _check(name, t, torch.int32, (Ba,), dev)
    if hd % 8:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8")
    _launch(
        name, "append_kv_bf16", cache_k, cache_v, new_k, new_v,
        lengths, rows, L, B, Ba, Hkv, S, hd,
    )
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# decode_attend_bf16
# ---------------------------------------------------------------------------


def decode_attend_plain(
    q, new_k, new_v, cache_k, cache_v, layer, lengths, slot_ids=None, scale=0.0
):
    """Plain version, in f32: attend positions [0, w] of each row, position
    w taking new_k/new_v. A parked row (w outside [0, S)) attends its new
    vectors alone."""
    rows = _rows(slot_ids, q.shape[0], q.device).long()
    k = cache_k[int(layer)].index_select(0, rows)  # [Ba, Hkv, S, hd]
    v = cache_v[int(layer)].index_select(0, rows)
    return _decode_rows_plain(q, new_k, new_v, k, v, lengths, scale)


def decode_attend_paged_plain(
    q, new_k, new_v, cache_k, cache_v, layer, lengths, block_tables, pool_k, pool_v,
    slot_ids=None, scale=0.0,
):
    """Plain version of the paged arm: `paged_gather` of each row's table
    (block_tables [B, nbs], rows picked by slot_ids), then the same math
    as `decode_attend_plain`."""
    rows = _rows(slot_ids, q.shape[0], q.device).long()
    tbl = block_tables.index_select(0, rows.to(block_tables.device))
    li = int(layer)
    k = paged_gather(cache_k[li], pool_k[li], tbl)
    v = paged_gather(cache_v[li], pool_v[li], tbl)
    return _decode_rows_plain(q, new_k, new_v, k, v, lengths, scale)


def _decode_rows_plain(q, new_k, new_v, k, v, lengths, scale):
    """Decode attention over gathered rows k/v [Ba, Hkv, S, hd], in f32."""
    Ba, Hkv, G, hd = q.shape
    S = k.shape[2]
    sc = scale or hd**-0.5
    k, v = k.float(), v.float()
    w = lengths.long()
    we = torch.where((w >= 0) & (w < S), w, torch.zeros_like(w))
    pos = torch.arange(S, device=q.device)
    at_w = (pos[None, :] == we[:, None])[:, None, None, :]  # [Ba, 1, 1, S]
    seen = (pos[None, :] <= we[:, None])[:, None, None, :]
    qf = q.float()
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k) * sc
    s_new = torch.einsum("bhgd,bhd->bhg", qf, new_k.float()) * sc
    s = torch.where(at_w, s_new[..., None], s)
    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p_w = torch.sum(torch.where(at_w, p, torch.zeros_like(p)), dim=-1)  # [Ba, Hkv, G]
    pv = torch.where(at_w, torch.zeros_like(p), p)
    ctx = torch.einsum("bhgs,bhsd->bhgd", pv, v)
    ctx = ctx + p_w[..., None] * new_v.float()[:, :, None, :]
    return ctx.to(q.dtype)


def decode_attend_bf16(
    q: torch.Tensor,  # [Ba, Hkv, G, hd]
    new_k: torch.Tensor,  # [Ba, Hkv, hd] — post-rope K for this step
    new_v: torch.Tensor,  # [Ba, Hkv, hd]
    cache_k: torch.Tensor,  # [L, B, Hkv, S, hd] — PRE-append cache
    cache_v: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,  # [Ba] int32 — this step's position per row
    *,
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool_k: torch.Tensor | None = None,  # [L, PXB, Hkv, bt, hd] prefix pool
    pool_v: torch.Tensor | None = None,
    scale: float = 0.0,  # query scale (0 = head_dim**-0.5)
    append: bool = False,  # also write new_k/new_v at (layer, slot, w)
) -> torch.Tensor:
    """One decode step's attention for one layer over the pre-append
    cache; position lengths[b] takes the exact new_k/new_v. With
    `block_tables` every block is read through cache row slot_ids[b]'s
    table (`decode_attend_bf16_paged`). With `append` the call then leaves
    this layer's new K/V rows in the cache, as `append_kv_bf16` of the
    layer would (the kernel writes them; the CPU path runs the plain
    append after the plain attention). Returns [Ba, Hkv, G, hd]."""
    if q.device.type == "cpu":
        if block_tables is not None:
            out = decode_attend_paged_plain(
                q, new_k, new_v, cache_k, cache_v, layer, lengths, block_tables,
                pool_k, pool_v, slot_ids, scale,
            )
        else:
            out = decode_attend_plain(
                q, new_k, new_v, cache_k, cache_v, layer, lengths, slot_ids, scale
            )
        if append:
            li = int(layer)
            append_kv_plain(cache_k[li:li + 1], cache_v[li:li + 1], new_k[None], new_v[None],
                            lengths, slot_ids)
        return out
    Ba, Hkv, G, hd = q.shape
    name = _arm("decode_attend_bf16" if block_tables is None else "decode_attend_bf16_paged", hd)
    L, B, _, S, _ = cache_k.shape
    dev = q.device
    rows = _rows(slot_ids, Ba, dev)
    _check(name, q, torch.bfloat16, (Ba, Hkv, G, hd), dev)
    for t in (new_k, new_v):
        _check(name, t, torch.bfloat16, (Ba, Hkv, hd), dev)
    for t in (cache_k, cache_v):
        _check(name, t, torch.bfloat16, (L, B, Hkv, S, hd), dev)
    for t in (lengths, rows):
        _check(name, t, torch.int32, (Ba,), dev)
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"{name}: built for head_dim in {HEAD_DIMS} and G <= {MAX_G}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    chunk = DECODE_CHUNK_BF16
    nsplit = -(-S // chunk)
    pm = torch.empty((Ba, Hkv, nsplit, G), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((Ba, Hkv, nsplit, G, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    sc = float(scale or hd**-0.5)
    if block_tables is None:
        _launch(
            name, _arm("decode_attend_bf16", hd), q, new_k, new_v, cache_k,
            cache_v, lengths, rows, pm, pl, pacc,
            out, int(layer), B, Ba, Hkv, G, S, hd, chunk, nsplit, sc, int(append),
        )
    else:
        nbs, bt, pxb = _check_paged(name, block_tables, pool_k, pool_v, L, B, Hkv, S, hd, dev)
        if block_tables.shape[0] != B:
            raise ValueError(f"{name}: block_tables has {block_tables.shape[0]} rows, cache {B}")
        _launch(
            name, _arm("decode_attend_bf16_paged", hd), q, new_k, new_v, cache_k,
            cache_v, lengths, rows, block_tables, pool_k, pool_v, pm, pl, pacc,
            out, int(layer), B, Ba, Hkv, G, S, hd, chunk, nsplit, nbs, bt, pxb, sc, int(append),
        )
    if append:
        LAUNCHES[_arm("append_kv_bf16_fused", hd)] += 1
    return out


# ---------------------------------------------------------------------------
# decode_attention (post-append)
# ---------------------------------------------------------------------------


def decode_attention_plain(q, cache_k, cache_v, lengths):
    """Plain version, in f32: attend positions pos <= lengths[b] of the
    post-append cache, scale head_dim**-0.5. As in JAX, masked scores are
    the finite -1e30: a row with lengths[b] < 0 weighs all S keys alike
    (the mean of V), lengths[b] >= S attends all S."""
    hd = q.shape[-1]
    S = cache_k.shape[2]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float() * hd**-0.5, cache_k.float())
    seen = torch.arange(S, device=q.device)[None, :] <= lengths.long()[:, None]
    s = torch.where(seen[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = torch.einsum("bhgs,bhsd->bhgd", p, cache_v.float())
    return (ctx / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, Hkv, G, hd]
    cache_k: torch.Tensor,  # [B, Hkv, S, hd] — this step's K already written
    cache_v: torch.Tensor,  # [B, Hkv, S, hd]
    lengths: torch.Tensor,  # [B] int32 — current write position (inclusive)
) -> torch.Tensor:
    """Batched single-step attention over the post-append cache: row b
    attends positions <= lengths[b] (all S when lengths[b] >= S; the mean
    of V over S when lengths[b] < 0, as JAX's finite mask gives). Scale
    head_dim**-0.5. Returns [B, Hkv, G, hd]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, lengths)
    B, Hkv, G, hd = q.shape
    name = _arm("decode_attention", hd)
    S = cache_k.shape[2]
    dev = q.device
    _check(name, q, torch.bfloat16, (B, Hkv, G, hd), dev)
    for t in (cache_k, cache_v):
        _check(name, t, torch.bfloat16, (B, Hkv, S, hd), dev)
    _check(name, lengths, torch.int32, (B,), dev)
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"{name}: built for head_dim in {HEAD_DIMS} and G <= {MAX_G}")
    chunk = DECODE_CHUNK_BF16
    nsplit = -(-S // chunk)
    pm = torch.empty((B, Hkv, nsplit, G), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, Hkv, nsplit, G, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    _launch(
        name, _arm("decode_attention_bf16", hd), q, cache_k, cache_v, lengths, pm, pl, pacc, out,
        B, Hkv, G, S, hd, chunk, nsplit, float(hd**-0.5),
    )
    return out


# ---------------------------------------------------------------------------
# flash_prefill_attention
# ---------------------------------------------------------------------------


def flash_prefill_plain(q, k, v, lengths, window=0, softcap=0.0, scale=0.0):
    """Plain version, in f32: causal + length (+ window) masked softmax
    attention; rows that see no key emit 0."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    sc = scale or hd**-0.5
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.matmul(q.float() * sc, kf.transpose(-1, -2))  # [B, H, S, S]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = (kp <= qp)[None] & (kp[None] < lengths.long()[:, None, None])  # [B, S, S]
    window = int(window)
    if window > 0:
        mask = mask & (qp - kp < window)[None]
    mask = mask[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


def flash_prefill_attention(
    q: torch.Tensor,  # [B, H, S, hd]
    k: torch.Tensor,  # [B, Hkv, S, hd]
    v: torch.Tensor,  # [B, Hkv, S, hd]
    lengths: torch.Tensor,  # [B] int32
    *,
    window: int = 0,  # sliding window (0 = global)
    softcap: float = 0.0,  # score soft-capping (0 = off)
    scale: float = 0.0,  # query scale (0 = head_dim**-0.5)
) -> torch.Tensor:
    """Causal, length-masked GQA flash attention. Returns [B, H, S, hd].
    head_dim 128 launches `flash_prefill_bf16`, 64 (Llama-3.2-1B,
    Qwen2.5-0.5B) `flash_prefill_bf16_hd64`, 256 (Gemma-2)
    `flash_prefill_bf16_hd256`."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, lengths, window, softcap, scale)
    B, H, S, hd = q.shape
    name = _arm("flash_prefill_attention", hd)
    Hkv = k.shape[1]
    dev = q.device
    _check(name, q, torch.bfloat16, (B, H, S, hd), dev)
    for t in (k, v):
        _check(name, t, torch.bfloat16, (B, Hkv, S, hd), dev)
    _check(name, lengths, torch.int32, (B,), dev)
    if hd not in FLASH_HEAD_DIMS or H % Hkv:
        raise ValueError(f"{name}: built for head_dim in {FLASH_HEAD_DIMS} and H % Hkv == 0")
    out = torch.empty_like(q)
    _launch(
        name, _arm("flash_prefill_bf16", hd), q, k, v, lengths, out,
        B, H, Hkv, S, hd, int(window), float(softcap), float(scale or hd**-0.5),
    )
    return out


# ---------------------------------------------------------------------------
# ragged_prefill_attend_bf16
# ---------------------------------------------------------------------------


def ragged_prefill_plain(
    q, k_self, v_self, cache_k, cache_v, layer, rowids, offsets, slots, starts, scale=0.0
):
    """Plain version, in f32, one packed segment at a time: row r's tokens
    attend cache row slots[r] over [0, starts[r]) and their own segment
    causally; the pad tokens after offsets[R] form one more segment with
    no cached prefix."""
    li = int(layer)
    sl = [int(x) for x in slots.tolist()]

    def past(r, start):
        return cache_k[li, sl[r], :, :start].float(), cache_v[li, sl[r], :, :start].float(), None, None

    return _ragged_rows_plain(q, k_self, v_self, past, offsets, starts, scale)


def _ragged_rows_plain(q, k_self, v_self, past, offsets, starts, scale):
    """The ragged plain math. `past(r, start)` gives row r's cached prefix
    as (k, v) [Hkv, start, hd] in f32 and, for an int8 cache, its dequant
    scales (kss, vss) [Hkv, start] (else None): the scores take kss after
    the dot and the probabilities vss before the PV product, as the JAX
    q8 kernel does."""
    T, Hkv, G, hd = q.shape
    R = starts.shape[0]
    sc = scale or hd**-0.5
    offs = [int(x) for x in offsets.tolist()] + [T]
    st = [int(x) for x in starts.tolist()]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for r in range(R + 1):
        lo, hi = offs[r], offs[r + 1]
        n = hi - lo
        if n <= 0:
            continue
        qr = q[lo:hi].float().permute(1, 2, 0, 3)  # [Hkv, G, n, hd]
        kr = k_self[lo:hi].float().permute(1, 0, 2)  # [Hkv, n, hd]
        vr = v_self[lo:hi].float().permute(1, 0, 2)
        s_self = torch.einsum("hgtd,hud->hgtu", qr, kr) * sc
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=q.device))
        s_self = torch.where(causal, s_self, torch.full_like(s_self, NEG_INF))
        start = st[r] if r < R else 0
        if start > 0:
            kp, vp, kss, vss = past(r, start)
            s_past = torch.einsum("hgtd,hsd->hgts", qr, kp)
            if kss is not None:
                s_past = s_past * kss[:, None, None, :]
            s_past = s_past * sc
            p = torch.softmax(torch.cat([s_past, s_self], dim=-1), dim=-1)
            pp = p[..., :start] if vss is None else p[..., :start] * vss[:, None, None, :]
            ctx = torch.einsum("hgts,hsd->hgtd", pp, vp)
            ctx = ctx + torch.einsum("hgtu,hud->hgtd", p[..., start:], vr)
        else:
            p = torch.softmax(s_self, dim=-1)
            ctx = torch.einsum("hgtu,hud->hgtd", p, vr)
        out[lo:hi] = ctx.permute(2, 0, 1, 3)
    return out.to(q.dtype)


def ragged_prefill_paged_plain(
    q, k_self, v_self, cache_k, cache_v, layer, rowids, offsets, slots, starts,
    block_tables, pool_k, pool_v, scale=0.0,
):
    """Plain version of the block-table path: `paged_gather` of each
    descriptor row's table (block_tables [B, nbs] gathered at slots), then
    the same math as `ragged_prefill_plain` over the gathered rows."""
    li = int(layer)
    tbl = block_tables.index_select(0, slots.long().to(block_tables.device))
    krows = paged_gather(cache_k[li], pool_k[li], tbl)  # [R, Hkv, S, hd]
    vrows = paged_gather(cache_v[li], pool_v[li], tbl)
    own = torch.arange(slots.shape[0], dtype=torch.int32, device=slots.device)
    return ragged_prefill_plain(
        q, k_self, v_self, krows[None], vrows[None], 0, rowids, offsets, own, starts, scale
    )


def ragged_prefill_attend_bf16(
    q: torch.Tensor,  # [T, Hkv, G, hd] post-rope queries (packed)
    k_self: torch.Tensor,  # [T, Hkv, hd] the chunk's own post-rope keys
    v_self: torch.Tensor,  # [T, Hkv, hd]
    cache_k: torch.Tensor,  # [L, B, Hkv, S, hd]
    cache_v: torch.Tensor,
    layer: int,
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token (pads = R)
    offsets: torch.Tensor,  # [R+1] int32 — packed row boundaries
    slots: torch.Tensor,  # [R] int32
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    *,
    scale: float = 0.0,
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool_k: torch.Tensor | None = None,  # [L, PXB, Hkv, bt, hd] prefix pool
    pool_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged chunked-prefill attention over the bf16 cache. With
    `block_tables` each row's cached prefix is read through the table of
    its slot (`ragged_prefill_attend_bf16_paged`). Returns [T, Hkv, G, hd]."""
    if q.device.type == "cpu":
        if block_tables is not None:
            return ragged_prefill_paged_plain(
                q, k_self, v_self, cache_k, cache_v, layer, rowids, offsets, slots,
                starts, block_tables, pool_k, pool_v, scale,
            )
        return ragged_prefill_plain(
            q, k_self, v_self, cache_k, cache_v, layer, rowids, offsets, slots,
            starts, scale,
        )
    T, Hkv, G, hd = q.shape
    name = _arm("ragged_prefill_attend_bf16" if block_tables is None
                else "ragged_prefill_attend_bf16_paged", hd)
    L, B, _, S, _ = cache_k.shape
    R = slots.shape[0]
    dev = q.device
    _check(name, q, torch.bfloat16, (T, Hkv, G, hd), dev)
    for t in (k_self, v_self):
        _check(name, t, torch.bfloat16, (T, Hkv, hd), dev)
    for t in (cache_k, cache_v):
        _check(name, t, torch.bfloat16, (L, B, Hkv, S, hd), dev)
    _check(name, rowids, torch.int32, (T,), dev)
    _check(name, offsets, torch.int32, (R + 1,), dev)
    for t in (slots, starts):
        _check(name, t, torch.int32, (R,), dev)
    if hd not in HEAD_DIMS or not 1 <= G <= 64:
        raise ValueError(f"{name}: built for head_dim in {HEAD_DIMS} and G <= 64")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    out = torch.empty_like(q)
    sc = float(scale or hd**-0.5)
    if block_tables is None:
        _launch(
            name, _arm("ragged_prefill_bf16", hd), q, k_self, v_self, cache_k,
            cache_v, rowids, offsets, slots, starts, out,
            int(layer), T, R, B, Hkv, G, S, hd, sc,
        )
        return out
    nbs, bt, pxb = _check_paged(name, block_tables, pool_k, pool_v, L, B, Hkv, S, hd, dev)
    # the descriptor rows' tables, as JAX's `_ragged_tables` gathers them
    tbl = block_tables.index_select(0, slots.long()).contiguous()
    _launch(
        name, _arm("ragged_prefill_bf16_paged", hd), q, k_self, v_self, cache_k,
        cache_v, rowids, offsets, slots, starts, tbl, pool_k, pool_v, out,
        int(layer), T, R, B, Hkv, G, S, hd, nbs, bt, pxb, sc,
    )
    return out


# ---------------------------------------------------------------------------
# int8 (fused cache): append_kv_q8, decode_attend_q8, ragged_prefill_attend_q8
# ---------------------------------------------------------------------------


def fused_q8_heads(cache_k: dict) -> tuple[int, int]:
    """(Hkv, p) of a fused int8 cache: the payload carries 2*Hkv K|V heads
    plus p in {0, 1} packed-scale pseudo-heads; "s" has exactly 2*Hkv."""
    Hs = cache_k["s"].shape[2]
    return Hs // 2, cache_k["q"].shape[2] - Hs


def q8_group(seq_len: int) -> int:
    """Keys per probability requantization group of the contiguous decode
    arm: the first of 256/128/64/32 dividing S (JAX's blocked-arm BS), 0
    when none does (JAX then takes its exact f32 fallback)."""
    return next((c for c in (256, 128, 64, 32) if seq_len % c == 0), 0)


def decode_pallas_max_seq(
    head_dim: int, n_kv_heads: int, n_heads: int, quantized: bool
) -> int:
    """Longest cache row JAX's whole-S decode bodies stream through VMEM
    (a copy of `llm_mcp_tpu/kernels/attention.py:decode_pallas_max_seq`,
    the same arithmetic): JAX runs its whole-S int8 body up to this length
    and its exact f32 fallback past it where no int8 block divides S. The
    port keeps JAX's choice of requantization group with it."""
    budget = 12 * 1024 * 1024  # of ~16 MB VMEM; headroom for q/out/temps
    if quantized:
        per_pos = 2 * (2 * n_kv_heads * head_dim) + 8 * n_kv_heads + 2 * 4 * n_heads
    else:
        g = max(1, n_heads // n_kv_heads)
        per_pos = 2 * (2 * head_dim * 2) + 4 * g
    return max(128, budget // per_pos)


def q8_contig_group(S: int, hd: int, Hkv: int, H: int) -> int:
    """The requantization group of the contiguous int8 decode, JAX's: the
    blocked arm's `q8_group(S)` where an int8 block divides S; else the
    whole row (S, JAX's whole-S body) where the row fits that body's
    budget; else 0, JAX's exact f32 fallback."""
    group = q8_group(S)
    if group == 0 and S <= decode_pallas_max_seq(hd, Hkv, H, quantized=True):
        group = S
    return group


def q8_decode_plan(S: int, hd: int, Hkv: int, H: int,
                   nbs: int | None = None) -> tuple[int, int, int]:
    """(group, split, splits a row) of the int8 decode kernel at head_dim
    hd, Hkv KV heads and H query heads. The group is what JAX requantizes
    p per: `q8_contig_group` contiguous (a block of `q8_group(S)` keys,
    the whole row, or 0 for the exact arm), bt = S / nbs through tables. A
    row splits into DECODE_CHUNK-key CTAs; a group inside a split must be
    32..DECODE_CHUNK keys in whole 32-key copy stages dividing the split;
    the whole row (a score pass gives every split its scale) and the exact
    group are contiguous only: the tables' arm takes bt in {32, 64, 128,
    256}, JAX's `paged_ok`, and raises otherwise."""
    group = q8_contig_group(S, hd, Hkv, H) if nbs is None else S // nbs
    fits = group >= 32 and group % 32 == 0 and DECODE_CHUNK % group == 0
    if not (fits or (group in (0, S) and nbs is None)) or (nbs is not None and S % nbs):
        where = "contiguous" if nbs is None else f"{nbs} blocks"
        raise ValueError(f"decode_attend_q8: a {group}-key group (S={S}, {where}) does not "
                         f"tile a {DECODE_CHUNK}-key split in 32-key stages")
    return group, DECODE_CHUNK, -(-S // DECODE_CHUNK)


def _check_fused(name, cache_k, L, B, Hkv, S, hd, dev) -> None:
    """Check a fused int8 cache (or pool) on the card."""
    Hf = cache_k["q"].shape[2]
    if fused_q8_heads(cache_k) not in ((Hkv, 0), (Hkv, 1)):
        raise ValueError(f"{name}: payload has {Hf} heads, expected 2*Hkv (+1)")
    _check(name, cache_k["q"], torch.int8, (L, B, Hf, S, hd), dev)
    _check(name, cache_k["s"], torch.bfloat16, (L, B, 2 * Hkv, S), dev)


def append_kv_q8_plain(cache_k, new_k, new_v, lengths, slot_ids=None):
    """Plain version, in place: quantize row b's K/V of every layer
    (`quantize_kv`), pack its scales and write payload heads
    [0, 2*Hkv + p) and plain scales at position lengths[b] of cache row
    slot_ids[b]; rows outside [0, S) write nothing."""
    from ..models.llama import quantize_kv  # models import the kernels
    from ..models.quant import pack_scales

    cq, cs = cache_k["q"], cache_k["s"]
    S, hd = cq.shape[3], cq.shape[4]
    _, p = fused_q8_heads(cache_k)
    kq = quantize_kv(new_k, scale_dtype=cs.dtype)
    vq = quantize_kv(new_v, scale_dtype=cs.dtype)
    s_new = torch.cat([kq["s"], vq["s"]], dim=2)  # [L, Ba, 2*Hkv]
    pay = torch.cat([kq["q"], vq["q"]], dim=2)  # [L, Ba, 2*Hkv, hd]
    if p:
        pay = torch.cat([pay, pack_scales(s_new[..., None], hd)[..., 0, :]], dim=2)
    rows = _rows(slot_ids, new_k.shape[1], cq.device).long()
    w = lengths.long()
    live = (w >= 0) & (w < S)
    b_idx, w_idx = rows[live], w[live]
    cq[:, b_idx, :, w_idx] = pay[:, live].transpose(0, 1)
    cs[:, b_idx, :, w_idx] = s_new[:, live].transpose(0, 1)
    return cache_k


def append_kv_q8(
    cache_k: dict,  # fused {"q": int8 [L, B, 2*Hkv+p, S, hd], "s": [L, B, 2*Hkv, S]}
    cache_v: dict,  # {} — V rides cache_k's head axis
    new_k: torch.Tensor,  # [L, Ba, Hkv, hd] — this step's K, all layers
    new_v: torch.Tensor,
    lengths: torch.Tensor,  # [Ba] int32 — write position per row (>= S: skip)
    *,
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
) -> tuple[dict, dict]:
    """Quantize and append one decode step's K/V for all layers into the
    fused int8 cache, in place, bit for bit what JAX's `append_kv_q8`
    writes. Returns the (same) caches."""
    if cache_k["q"].device.type == "cpu":
        return append_kv_q8_plain(cache_k, new_k, new_v, lengths, slot_ids), cache_v
    name = "append_kv_q8"
    L, B, Hf, S, hd = cache_k["q"].shape
    Ba, Hkv = new_k.shape[1], new_k.shape[2]
    dev = cache_k["q"].device
    rows = _rows(slot_ids, Ba, dev)
    _check_fused(name, cache_k, L, B, Hkv, S, hd, dev)
    for t in (new_k, new_v):
        _check(name, t, torch.bfloat16, (L, Ba, Hkv, hd), dev)
    for t in (lengths, rows):
        _check(name, t, torch.int32, (Ba,), dev)
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: built for head_dim {HEAD_DIM}")
    _launch(name, "append_kv_q8", cache_k["q"], cache_k["s"], new_k, new_v, lengths, rows,
            L, B, Ba, Hkv, Hf, S)
    return cache_k, cache_v


def _q8_rows(cache_k, layer, rows, block_tables=None, pool=None):
    """Layer `layer` of the fused cache at cache rows `rows` (through their
    tables when given): payload [R, Hf, S, hd] and scales [R, 2*Hkv, S]."""
    li = int(layer)
    pay, ss = cache_k["q"][li], cache_k["s"][li]
    if block_tables is None:
        return pay.index_select(0, rows), ss.index_select(0, rows)
    tbl = block_tables.index_select(0, rows.to(block_tables.device))
    return paged_gather(pay, pool["q"][li], tbl), paged_gather(ss, pool["s"][li], tbl)


def decode_attend_q8_plain(
    q, new_k, new_v, cache_k, layer, lengths, slot_ids=None, scale=0.0, group=0,
    block_tables=None, pool_k=None,
):
    """Plain version, in f32, of the int8 decode kernels. With p = 1 the
    scales are read from the packed pseudo-head, as the kernel reads them.
    q is requantized per (h, g) row; the s8 x s8 dots are exact integers
    in f32 (|sum| < 2^24); position w takes the exact new_k/new_v. The
    probabilities times the V scales are requantized to int8 per `group`
    keys (the JAX blocked arm's BS, the paged arm's bt; `group = S` is the
    whole-S arm): p8 does not change when p is scaled by a constant, so
    one max over the row stands for JAX's running max. `group = 0` is the
    exact math of JAX's `_decode_attend_q8_fallback` (no requantization).
    A parked row (w outside [0, S)) attends its new vectors alone."""
    from ..models.quant import INV127, unpack_scales

    Ba, Hkv, G, hd = q.shape
    rows = _rows(slot_ids, Ba, q.device).long()
    pay, ss = _q8_rows(cache_k, layer, rows, block_tables, pool_k)
    S = pay.shape[2]
    Hs = ss.shape[1]
    if fused_q8_heads(cache_k)[1]:
        ss = unpack_scales(pay[:, Hs], Hs, ss.dtype)
    ss = ss.float()
    kss, vss = ss[:, :Hkv], ss[:, Hkv:]
    k8, v8 = pay[:, :Hkv].float(), pay[:, Hkv:Hs].float()
    sc = scale or hd**-0.5
    w = lengths.long()
    we = torch.where((w >= 0) & (w < S), w, torch.zeros_like(w))
    pos = torch.arange(S, device=q.device)
    at_w = (pos[None, :] == we[:, None])[:, None, None, :]  # [Ba, 1, 1, S]
    seen = (pos[None, :] <= we[:, None])[:, None, None, :]
    qf = q.float()
    s_new = torch.einsum("bhgd,bhd->bhg", qf, new_k.float()) * sc
    if group:
        qsc = torch.clamp(qf.abs().amax(dim=-1) * INV127, min=1e-30)  # [Ba, Hkv, G]
        q8 = torch.round(qf / qsc[..., None])
        s = torch.einsum("bhgd,bhsd->bhgs", q8, k8) * (sc * qsc)[..., None]
    else:
        s = torch.einsum("bhgd,bhsd->bhgs", qf * sc, k8)
    s = s * kss[:, :, None, :]
    s = torch.where(at_w, s_new[..., None], s)
    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
    p = torch.where(seen, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1)
    p_w = torch.sum(torch.where(at_w, p, torch.zeros_like(p)), dim=-1)  # [Ba, Hkv, G]
    pv = torch.where(at_w, torch.zeros_like(p), p * vss[:, :, None, :])
    if group:
        nb = S // group
        pg = pv.reshape(Ba, Hkv, G, nb, group)
        psc = torch.clamp(pg.amax(dim=-1) * INV127, min=1e-30)  # [Ba, Hkv, G, nb]
        p8 = torch.round(pg / psc[..., None])
        ci = torch.einsum("bhgjk,bhjkd->bhgjd", p8, v8.reshape(Ba, Hkv, nb, group, hd))
        ctx = (ci * psc[..., None]).sum(dim=3)
    else:
        ctx = torch.einsum("bhgs,bhsd->bhgd", pv, v8)
    ctx = ctx + p_w[..., None] * new_v.float()[:, :, None, :]
    return (ctx / l[..., None]).to(q.dtype)


def decode_attend_q8(
    q: torch.Tensor,  # [Ba, Hkv, G, hd]
    new_k: torch.Tensor,  # [Ba, Hkv, hd] — post-rope K for this step
    new_v: torch.Tensor,  # [Ba, Hkv, hd]
    cache_k: dict,  # fused int8 cache — PRE-append
    cache_v: dict,  # {}
    layer: int,
    lengths: torch.Tensor,  # [Ba] int32 — this step's position per row
    *,
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool_k: dict | None = None,  # {"q": int8 [L, PXB, 2*Hkv+p, bt, hd], "s": [L, PXB, 2*Hkv, bt]}
    scale: float = 0.0,  # query scale (0 = head_dim**-0.5)
    append: bool = False,  # also quantize and write new_k/new_v at (layer, slot, w)
) -> torch.Tensor:
    """One decode step's attention for one layer over the fused int8 cache
    (pre-append; position lengths[b] takes the exact new_k/new_v). The
    probabilities are requantized per `q8_group(S)` keys, or per block of
    bt keys through `block_tables` (`decode_attend_q8_paged`), as JAX's
    blocked and paged arms do; where no int8 group divides S, over the
    whole row where it fits JAX's whole-S budget (its whole-S body), else
    not at all (the exact arm, JAX's f32 fallback). `q8_decode_plan` gives
    the group and the split. With `append` the call then leaves this
    layer's new K/V row in the cache, as `append_kv_q8` of the layer would
    (bit for bit: the kernel quantizes and writes it; the CPU path runs the
    plain append after the plain attention). Returns [Ba, Hkv, G, hd]."""
    S = cache_k["q"].shape[3]
    Ba, Hkv, G, hd = q.shape
    nbs = None if block_tables is None else block_tables.shape[1]
    if q.device.type == "cpu":
        group = q8_contig_group(S, hd, Hkv, Hkv * G) if nbs is None else S // nbs
        out = decode_attend_q8_plain(
            q, new_k, new_v, cache_k, layer, lengths, slot_ids, scale, group,
            block_tables, pool_k,
        )
        if append:
            li = int(layer)
            append_kv_q8_plain({k: v[li:li + 1] for k, v in cache_k.items()}, new_k[None],
                               new_v[None], lengths, slot_ids)
        return out
    name = _arm("decode_attend_q8" if block_tables is None else "decode_attend_q8_paged", hd)
    L, B, Hf, _, _ = cache_k["q"].shape
    dev = q.device
    rows = _rows(slot_ids, Ba, dev)
    _check(name, q, torch.bfloat16, (Ba, Hkv, G, hd), dev)
    for t in (new_k, new_v):
        _check(name, t, torch.bfloat16, (Ba, Hkv, hd), dev)
    _check_fused(name, cache_k, L, B, Hkv, S, hd, dev)
    for t in (lengths, rows):
        _check(name, t, torch.int32, (Ba,), dev)
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"{name}: built for head_dim in {HEAD_DIMS} and G <= {MAX_G}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if block_tables is not None:
        nbs, bt, pxb = _check_paged_q8(name, block_tables, pool_k, L, B, Hkv, Hf, S, hd, dev)
        if block_tables.shape[0] != B:
            raise ValueError(f"{name}: block_tables has {block_tables.shape[0]} rows, cache {B}")
    group, chunk, nsplit = q8_decode_plan(S, hd, Hkv, Hkv * G, nbs)
    pm = torch.empty((Ba, Hkv, nsplit, G), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((Ba, Hkv, nsplit, G, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    sc = float(scale or hd**-0.5)
    if block_tables is None:
        row = group == S and q8_group(S) != S  # the whole-row arm: a score pass first
        # the score pass's (max, max of p * vss) of every split; other arms
        # pass null
        rs = (torch.empty((Ba, Hkv, nsplit, G, 2), dtype=torch.float32, device=dev)
              if row else None)
        _launch(
            name, _arm("decode_attend_q8", hd), q, new_k, new_v, cache_k["q"], cache_k["s"],
            lengths, rows, pm, pl, pacc, out,
            int(layer), B, Ba, Hkv, Hf, G, S, hd, chunk, nsplit, group, sc, rs, int(append),
        )
        if row:
            LAUNCHES[_arm("decode_attend_q8_row", hd)] += 1
    else:
        _launch(
            name, _arm("decode_attend_q8_paged", hd), q, new_k, new_v, cache_k["q"], cache_k["s"],
            lengths, rows, block_tables, pool_k["q"], pool_k["s"], pm, pl, pacc, out,
            int(layer), B, Ba, Hkv, Hf, G, S, hd, chunk, nsplit, nbs, bt, pxb, sc, int(append),
        )
    if append:
        LAUNCHES[_arm("append_kv_q8_fused", hd)] += 1
    return out


def _check_paged_q8(name, block_tables, pool, L, B, Hkv, Hf, S, hd, dev) -> tuple[int, int, int]:
    """Check the paged int8 operands; returns (nbs, bt, pool rows)."""
    if block_tables.dim() != 2 or block_tables.shape[1] < 1 or S % block_tables.shape[1]:
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} must be "
                         f"[rows, nbs] with nbs dividing S={S}")
    nbs = block_tables.shape[1]
    bt = S // nbs
    if not pool or pool["q"].dim() != 5 or pool["q"].shape[1] < 1:
        raise ValueError(f"{name}: block_tables need a prefix pool with at least one row")
    pxb = pool["q"].shape[1]
    if pool["q"].shape[2] != Hf:
        raise ValueError(f"{name}: pool payload has {pool['q'].shape[2]} heads, cache {Hf}")
    _check_fused(name, pool, L, pxb, Hkv, bt, hd, dev)
    _check(name, block_tables, torch.int32, (block_tables.shape[0], nbs), dev)
    return nbs, bt, pxb


def ragged_prefill_q8_plain(
    q, k_self, v_self, cache_k, layer, rowids, offsets, slots, starts, scale=0.0,
    block_tables=None, pool=None,
):
    """Plain version, in f32: the ragged math over each descriptor row's
    int8 past (payload as f32, dequantized after the dots by the plain
    scales, which are read through the same tables as the payload) and the
    chunk's own exact keys."""
    Hkv = q.shape[1]
    pay, ss = _q8_rows(cache_k, layer, slots.long(), block_tables, pool)

    def past(r, start):
        return (pay[r, :Hkv, :start].float(), pay[r, Hkv: 2 * Hkv, :start].float(),
                ss[r, :Hkv, :start].float(), ss[r, Hkv:, :start].float())

    return _ragged_rows_plain(q, k_self, v_self, past, offsets, starts, scale)


def ragged_prefill_attend_q8(
    q: torch.Tensor,  # [T, Hkv, G, hd] post-rope queries (packed)
    k_self: torch.Tensor,  # [T, Hkv, hd] the chunk's own post-rope keys, exact
    v_self: torch.Tensor,  # [T, Hkv, hd]
    cache_k: dict,  # fused int8 cache
    layer: int,
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token (pads = R)
    offsets: torch.Tensor,  # [R+1] int32 — packed row boundaries
    slots: torch.Tensor,  # [R] int32
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    *,
    scale: float = 0.0,
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool: dict | None = None,  # the fused prefix pool
) -> torch.Tensor:
    """Ragged chunked-prefill attention over the fused int8 cache: int8
    past keys dequantized (no requantization), the chunk's own segment in
    exact bf16. With `block_tables` each row's prefix, payload and scales,
    is read through its slot's table (`ragged_prefill_attend_q8_paged`).
    Returns [T, Hkv, G, hd]."""
    if q.device.type == "cpu":
        return ragged_prefill_q8_plain(
            q, k_self, v_self, cache_k, layer, rowids, offsets, slots, starts, scale,
            block_tables, pool,
        )
    T, Hkv, G, hd = q.shape
    name = _arm("ragged_prefill_attend_q8" if block_tables is None
                else "ragged_prefill_attend_q8_paged", hd)
    L, B, Hf, S, _ = cache_k["q"].shape
    R = slots.shape[0]
    dev = q.device
    _check(name, q, torch.bfloat16, (T, Hkv, G, hd), dev)
    for t in (k_self, v_self):
        _check(name, t, torch.bfloat16, (T, Hkv, hd), dev)
    _check_fused(name, cache_k, L, B, Hkv, S, hd, dev)
    _check(name, rowids, torch.int32, (T,), dev)
    _check(name, offsets, torch.int32, (R + 1,), dev)
    for t in (slots, starts):
        _check(name, t, torch.int32, (R,), dev)
    if hd not in HEAD_DIMS or not 1 <= G <= 64:
        raise ValueError(f"{name}: built for head_dim in {HEAD_DIMS} and G <= 64")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    out = torch.empty_like(q)
    sc = float(scale or hd**-0.5)
    if block_tables is None:
        _launch(
            name, _arm("ragged_prefill_q8", hd), q, k_self, v_self, cache_k["q"], cache_k["s"],
            rowids, offsets, slots, starts, out,
            int(layer), T, R, B, Hkv, Hf, G, S, hd, sc,
        )
        return out
    nbs, bt, pxb = _check_paged_q8(name, block_tables, pool, L, B, Hkv, Hf, S, hd, dev)
    tbl = block_tables.index_select(0, slots.long()).contiguous()
    _launch(
        name, _arm("ragged_prefill_q8_paged", hd), q, k_self, v_self, cache_k["q"], cache_k["s"],
        rowids, offsets, slots, starts, tbl, pool["q"], pool["s"], out,
        int(layer), T, R, B, Hkv, Hf, G, S, hd, nbs, bt, pxb, sc,
    )
    return out


# ---------------------------------------------------------------------------
# MLA (latent cache): decode_attend_q8_mla, ragged_prefill_attend_mla
# ---------------------------------------------------------------------------
#
# The latent cache of `models/mla.py`: latents [L, B, 1, S, R] and shared
# rope keys [L, B, 1, S, dr], bf16 arrays or, at int8, one {"q", "s"} dict
# each (payload and per-token scales [L, B, 1, S]); pools mirror them with
# [L, PXB, 1, bt, ...]. The kernels are built for DeepSeek's R = 512 and
# dr = 64.

MLA_R = 512  # kv_lora_rank the MLA kernels are built for
MLA_DR = 64  # qk_rope_head_dim the MLA kernels are built for


def mla_whole_s_fits(S: int, R: int, dr: int, H: int) -> bool:
    """JAX's whole-S VMEM test for the MLA decode kernel (its static arm
    choice: whole row if it fits, else blocks)."""
    return (S * (R + dr) + 4 * S * (3 * H + dr) + 4 * H * (2 * R + dr)) <= 8 * 1024 * 1024


def mla_block_size(seq_len: int) -> int:
    """JAX's blocked-arm block size: the first of 512/256/128 dividing S,
    0 past 64 blocks (JAX then takes its exact f32 fallback)."""
    bs = next((c for c in (512, 256, 128) if seq_len % c == 0), 0)
    return 0 if bs and seq_len // bs > 64 else bs


def mla_decode_group(S: int, R: int, dr: int, H: int, nbs: int | None = None) -> int:
    """Keys per probability requantization group of the MLA decode kernel,
    as JAX's dispatch picks its arm statically: contiguous, the whole row
    (S) when the whole-S kernel fits, else the blocked arm's block size;
    through tables of nbs blocks, bt when the paged kernel takes them
    (bt >= 32, at most 64 blocks). 0 is JAX's exact f32 fallback, which
    does not requantize."""
    if nbs is None:
        return S if mla_whole_s_fits(S, R, dr, H) else mla_block_size(S)
    bt = S // nbs
    return bt if S % nbs == 0 and bt >= 32 and nbs <= 64 else 0


def _mla_plane(cache, layer, rows, tbl=None, pool=None):
    """Layer `layer` of one latent-cache plane at cache rows `rows` (through
    their tables when given), the fake head axis dropped: [n, S, ...]."""
    li = int(layer)
    if tbl is None:
        return cache[li].index_select(0, rows)[:, 0]
    return paged_gather(cache[li], pool[li], tbl.index_select(0, rows.to(tbl.device)))[:, 0]


def decode_attend_q8_mla_plain(
    qt, qr, new_c, new_r, cache_c, cache_r, layer, lengths, slot_ids=None, scale=0.0,
    group=0, block_tables=None, pool_c=None, pool_r=None,
):
    """Plain version of the MLA int8 decode kernels. With `group` > 0 the
    Pallas bodies' arithmetic: q̃ requantized per head (qsc = max|q̃| /
    127), latent scores s8 x s8 times scale * qsc * ls, rope scores
    over the dequantized rope keys, position w overridden by the exact
    score, and p * ls requantized per `group` keys (S: JAX's whole-S arm,
    the block size: its blocked arm, bt: its paged arm), the PV product
    s8 x s8 again. `group` = 0 is JAX's exact fallback. Integer dots run in
    float64, which holds them exactly. A parked row (w outside [0, S))
    attends its new vectors alone."""
    from ..models.quant import INV127

    Ba, H, R = qt.shape
    rows = _rows(slot_ids, Ba, qt.device).long()
    pc = pool_c or {"q": None, "s": None}
    pr = pool_r or {"q": None, "s": None}
    lat = _mla_plane(cache_c["q"], layer, rows, block_tables, pc["q"]).double()  # [Ba, S, R]
    ls = _mla_plane(cache_c["s"], layer, rows, block_tables, pc["s"]).float()  # [Ba, S]
    rop = _mla_plane(cache_r["q"], layer, rows, block_tables, pr["q"]).float()
    rs = _mla_plane(cache_r["s"], layer, rows, block_tables, pr["s"]).float()
    S = lat.shape[1]
    w = lengths.long()
    we = torch.where((w >= 0) & (w < S), w, torch.zeros_like(w))
    pos = torch.arange(S, device=qt.device)
    at_w = (pos[None, :] == we[:, None])[:, None, :]  # [Ba, 1, S]
    seen = (pos[None, :] <= we[:, None])[:, None, :]
    qtf, qrf = qt.float(), qr.float()
    nc = new_c.float()
    s_new = ((qtf * nc[:, None, :]).sum(-1) + (qrf * new_r.float()[:, None, :]).sum(-1)) * scale
    if group:
        qsc = torch.clamp(qtf.abs().amax(dim=-1) * INV127, min=1e-30)  # [Ba, H]
        qt8 = torch.round(qtf / qsc[..., None])
        si = torch.einsum("bhr,bsr->bhs", qt8.double(), lat).float()
        s = si * (scale * qsc)[..., None] * ls[:, None, :]
        s = s + torch.einsum("bhd,bsd->bhs", qrf, rop * rs[..., None]) * scale
    else:
        s = (torch.einsum("bhr,bsr->bhs", qtf.double(), lat).float() * ls[:, None, :]
             + torch.einsum("bhd,bsd->bhs", qrf, rop) * rs[:, None, :]) * scale
    s = torch.where(at_w, s_new[..., None], s)
    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
    p = torch.where(seen, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1)
    p_w = torch.where(at_w, p, torch.zeros_like(p)).sum(dim=-1)  # [Ba, H]
    pv = torch.where(at_w, torch.zeros_like(p), p * ls[:, None, :])
    if group:
        nb = -(-S // group)
        pad = nb * group - S
        pg = F.pad(pv, (0, pad)).reshape(Ba, H, nb, group)
        psc = torch.clamp(pg.amax(dim=-1) * INV127, min=1e-30)  # [Ba, H, nb]
        p8 = torch.round(pg / psc[..., None])
        latg = F.pad(lat, (0, 0, 0, pad)).reshape(Ba, nb, group, R)
        ci = torch.einsum("bhjk,bjkr->bhjr", p8.double(), latg).float()
        ctx = (ci * psc[..., None]).sum(dim=2)
    else:
        ctx = torch.einsum("bhs,bsr->bhr", pv.double(), lat).float()
    ctx = ctx + p_w[..., None] * nc[:, None, :]
    return (ctx / l[..., None]).to(qt.dtype)


def _check_mla_plane(name, plane, L, B, S, width, dev, quantized) -> None:
    if quantized:
        if not isinstance(plane, dict) or set(plane) != {"q", "s"}:
            raise ValueError(f"{name}: an int8 latent plane is a {{'q', 's'}} dict")
        _check(name, plane["q"], torch.int8, (L, B, 1, S, width), dev)
        _check(name, plane["s"], torch.bfloat16, (L, B, 1, S), dev)
    else:
        _check(name, plane, torch.bfloat16, (L, B, 1, S, width), dev)


def _mla_tables(name, block_tables, S, dev) -> tuple[int, int]:
    """(nbs, bt) of the engine's [B, nbs] tables."""
    if block_tables.dim() != 2 or block_tables.shape[1] < 1 or S % block_tables.shape[1]:
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} must be "
                         f"[rows, nbs] with nbs dividing S={S}")
    _check(name, block_tables, torch.int32, tuple(block_tables.shape), dev)
    nbs = block_tables.shape[1]
    return nbs, S // nbs


MLA_DECODE_SPLIT = 128  # keys a CTA of the MLA decode kernel takes (its CH)


def mla_decode_plan(S: int, group: int, Ba: int, H: int, R: int = MLA_R) -> tuple[int, int]:
    """(splits a row, f32 workspace elements) of the MLA decode kernel:
    every row splits into MLA_DECODE_SPLIT-key CTAs whatever its group; a
    group must be exact (0), the whole row, whole splits or whole groups of
    at least 32 keys inside a split, so that each split's p8 can take its
    group's scale (raises otherwise). The workspace holds each split's
    f32 partial context [Ba, splits, H, R], the scores [Ba, H, splits *
    split] and each split's max, sum and max of p * ls per head [Ba,
    splits, 3, H]."""
    sp = MLA_DECODE_SPLIT
    if not (group == 0 or group >= S or group % sp == 0 or (group >= 32 and sp % group == 0)):
        raise ValueError(f"decode_attend_q8_mla: a {group}-key group (S={S}) neither holds "
                         f"nor fits whole {sp}-key splits")
    nsplit = -(-S // sp)
    return nsplit, Ba * H * nsplit * (sp + 3 + R)


def decode_attend_q8_mla(
    qt: torch.Tensor,  # [Ba, H, R] absorbed queries (latent space)
    qr: torch.Tensor,  # [Ba, H, dr] rope queries (after rope)
    new_c: torch.Tensor,  # [Ba, R] this step's exact latent
    new_r: torch.Tensor,  # [Ba, dr] this step's exact rope key
    cache_c: dict,  # {"q": int8 [L, B, 1, S, R], "s": [L, B, 1, S]} — PRE-append
    cache_r: dict,  # {"q": int8 [L, B, 1, S, dr], "s": [L, B, 1, S]}
    layer: int,
    lengths: torch.Tensor,  # [Ba] int32 — this step's position per row
    *,
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool_c: dict | None = None,  # latent prefix pool {"q": [L, PXB, 1, bt, R], "s"}
    pool_r: dict | None = None,  # rope prefix pool
    scale: float,
) -> torch.Tensor:
    """Absorbed MLA decode attention for one layer over the int8 latent
    cache, pre-append (position lengths[b] takes the exact new_c/new_r).
    Returns the context in latent space [Ba, H, R]; the caller appends.
    The probabilities are requantized per `mla_decode_group` keys, JAX's
    static choice of arm; with `block_tables` every key is read through
    row slot_ids[b]'s table (`decode_attend_q8_mla_paged`). Every row
    splits into MLA_DECODE_SPLIT-key CTAs (`mla_decode_plan`), all heads
    in each; a group's scale is taken over the whole group before p is
    requantized."""
    Ba, H, R = qt.shape
    dr = qr.shape[-1]
    L, B, _, S, _ = cache_c["q"].shape
    nbs = None if block_tables is None else block_tables.shape[1]
    group = mla_decode_group(S, R, dr, H, nbs)
    if qt.device.type == "cpu":
        return decode_attend_q8_mla_plain(
            qt, qr, new_c, new_r, cache_c, cache_r, layer, lengths, slot_ids, scale, group,
            block_tables, pool_c, pool_r,
        )
    name = "decode_attend_q8_mla" if block_tables is None else "decode_attend_q8_mla_paged"
    dev = qt.device
    rows = _rows(slot_ids, Ba, dev)
    _check(name, qt, torch.bfloat16, (Ba, H, R), dev)
    _check(name, qr, torch.bfloat16, (Ba, H, dr), dev)
    _check(name, new_c, torch.bfloat16, (Ba, R), dev)
    _check(name, new_r, torch.bfloat16, (Ba, dr), dev)
    _check_mla_plane(name, cache_c, L, B, S, R, dev, True)
    _check_mla_plane(name, cache_r, L, B, S, dr, dev, True)
    for t in (lengths, rows):
        _check(name, t, torch.int32, (Ba,), dev)
    if R != MLA_R or dr != MLA_DR:
        raise ValueError(f"{name}: built for kv_lora_rank {MLA_R} and rope dim {MLA_DR}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if block_tables is not None:
        nbs, bt = _mla_tables(name, block_tables, S, dev)
        if block_tables.shape[0] != B:
            raise ValueError(f"{name}: block_tables has {block_tables.shape[0]} rows, cache {B}")
        if pool_c is None or pool_r is None:
            raise ValueError(f"{name}: block_tables need the latent and rope pools")
        pxb = pool_c["q"].shape[1]
        _check_mla_plane(name, pool_c, L, pxb, bt, R, dev, True)
        _check_mla_plane(name, pool_r, L, pxb, bt, dr, dev, True)
    _, ws_len = mla_decode_plan(S, group, Ba, H, R)
    out = torch.empty_like(qt)
    ws = torch.empty((ws_len,), dtype=torch.float32, device=dev)
    if block_tables is None:
        _launch(name, "decode_attend_q8_mla", qt, qr, new_c, new_r, cache_c["q"],
                cache_c["s"], cache_r["q"], cache_r["s"], lengths, rows, out, ws,
                int(layer), B, Ba, H, S, R, dr, group, MLA_DECODE_SPLIT, float(scale))
        return out
    _launch(name, "decode_attend_q8_mla_paged", qt, qr, new_c, new_r, cache_c["q"],
            cache_c["s"], cache_r["q"], cache_r["s"], lengths, rows, block_tables,
            pool_c["q"], pool_c["s"], pool_r["q"], pool_r["s"], out, ws,
            int(layer), B, Ba, H, S, R, dr, group, MLA_DECODE_SPLIT, nbs, bt, pxb,
            float(scale))
    return out


def ragged_prefill_mla_plain(
    qt, qr, c_self, kr_self, cache_c, cache_r, layer, rowids, offsets, slots, starts,
    scale=0.0, block_tables=None, pool_c=None, pool_r=None,
):
    """Plain version of the ragged MLA kernel, in f32, one packed segment
    at a time: past scores (q̃ . lat) * ls + (qr . rop) * rs over the row's
    cached prefix (through its slot's table when given; ls = rs = 1 for
    bf16 latents), self scores q̃ . c + qr . kr over its own causal
    segment, one softmax over both times `scale`, and the context over
    lat * ls (past) and c (self). Pads after offsets[R] form one more
    segment with no prefix."""
    T, H, Rl = qt.shape
    quantized = isinstance(cache_c, dict)
    rows = slots.long()
    if quantized:
        pc = pool_c or {"q": None, "s": None}
        pr = pool_r or {"q": None, "s": None}
        lat = _mla_plane(cache_c["q"], layer, rows, block_tables, pc["q"])
        ls = _mla_plane(cache_c["s"], layer, rows, block_tables, pc["s"]).float()
        rop = _mla_plane(cache_r["q"], layer, rows, block_tables, pr["q"])
        rs = _mla_plane(cache_r["s"], layer, rows, block_tables, pr["s"]).float()
    else:
        lat = _mla_plane(cache_c, layer, rows, block_tables, pool_c)
        rop = _mla_plane(cache_r, layer, rows, block_tables, pool_r)
        ls = rs = None
    R = starts.shape[0]
    offs = [int(x) for x in offsets.tolist()] + [T]
    st = [int(x) for x in starts.tolist()]
    out = torch.zeros((T, H, Rl), dtype=torch.float32, device=qt.device)
    for r in range(R + 1):
        lo, hi = offs[r], offs[r + 1]
        n = hi - lo
        if n <= 0:
            continue
        q1, q2 = qt[lo:hi].float(), qr[lo:hi].float()
        c, kr = c_self[lo:hi].float(), kr_self[lo:hi].float()
        s_self = (torch.einsum("thr,ur->htu", q1, c) + torch.einsum("thd,ud->htu", q2, kr)) * scale
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=qt.device))
        s_self = torch.where(causal, s_self, torch.full_like(s_self, NEG_INF))
        start = min(st[r], lat.shape[1]) if r < R else 0
        if start > 0:
            lp, rp = lat[r, :start].float(), rop[r, :start].float()
            s_lat = torch.einsum("thr,sr->hts", q1, lp)
            s_rop = torch.einsum("thd,sd->hts", q2, rp)
            if ls is not None:
                s_lat = s_lat * ls[r, :start]
                s_rop = s_rop * rs[r, :start]
            p = torch.softmax(torch.cat([(s_lat + s_rop) * scale, s_self], dim=-1), dim=-1)
            pp = p[..., :start] if ls is None else p[..., :start] * ls[r, :start]
            ctx = torch.einsum("hts,sr->thr", pp, lp) + torch.einsum("htu,ur->thr", p[..., start:], c)
        else:
            ctx = torch.einsum("htu,ur->thr", torch.softmax(s_self, dim=-1), c)
        out[lo:hi] = ctx
    return out.to(qt.dtype)


def ragged_prefill_attend_mla(
    qt: torch.Tensor,  # [T, H, R] absorbed queries (packed)
    qr: torch.Tensor,  # [T, H, dr] rope queries (after rope)
    c_self: torch.Tensor,  # [T, R] the chunk's own latents, exact
    kr_self: torch.Tensor,  # [T, dr] the chunk's own rope keys (after rope)
    cache_c,  # latents [L, B, 1, S, R] bf16, or the int8 {"q", "s"} dict
    cache_r,  # rope keys [L, B, 1, S, dr], or the int8 dict
    layer: int,
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token (pads = R)
    offsets: torch.Tensor,  # [R+1] int32 — packed row boundaries
    slots: torch.Tensor,  # [R] int32
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    *,
    scale: float,
    block_tables: torch.Tensor | None = None,  # [B, nbs] int32 physical tables
    pool_c=None,  # latent prefix pool, like cache_c with [L, PXB, 1, bt, ...]
    pool_r=None,  # rope prefix pool
) -> torch.Tensor:
    """Ragged chunked-prefill attention over the latent cache (absorbed
    form), bf16 or int8 latents, no requantization. With `block_tables`
    each row's cached prefix is read through its slot's table. Returns the
    attended latent context [T, H, R]; the caller re-expands it through
    W_uv. Launch counters: `ragged_prefill_attend_mla[_q8][_paged]`."""
    quantized = isinstance(cache_c, dict)
    if qt.device.type == "cpu":
        return ragged_prefill_mla_plain(
            qt, qr, c_self, kr_self, cache_c, cache_r, layer, rowids, offsets, slots, starts,
            scale, block_tables, pool_c, pool_r,
        )
    name = ("ragged_prefill_attend_mla" + ("_q8" if quantized else "")
            + ("_paged" if block_tables is not None else ""))
    T, H, R = qt.shape
    dr = qr.shape[-1]
    L, B, _, S, _ = (cache_c["q"] if quantized else cache_c).shape
    Rn = slots.shape[0]
    dev = qt.device
    _check(name, qt, torch.bfloat16, (T, H, R), dev)
    _check(name, qr, torch.bfloat16, (T, H, dr), dev)
    _check(name, c_self, torch.bfloat16, (T, R), dev)
    _check(name, kr_self, torch.bfloat16, (T, dr), dev)
    _check_mla_plane(name, cache_c, L, B, S, R, dev, quantized)
    _check_mla_plane(name, cache_r, L, B, S, dr, dev, quantized)
    _check(name, rowids, torch.int32, (T,), dev)
    _check(name, offsets, torch.int32, (Rn + 1,), dev)
    for t in (slots, starts):
        _check(name, t, torch.int32, (Rn,), dev)
    if R != MLA_R or dr != MLA_DR or 64 % H:
        raise ValueError(f"{name}: built for kv_lora_rank {MLA_R}, rope dim {MLA_DR} and "
                         f"heads dividing 64")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    out = torch.empty_like(qt)
    planes = ((cache_c["q"], cache_c["s"], cache_r["q"], cache_r["s"]) if quantized
              else (cache_c, cache_r))
    symbol = "ragged_prefill_mla" + ("_q8" if quantized else "")
    if block_tables is None:
        _launch(name, symbol, qt, qr, c_self, kr_self, *planes, rowids, offsets, slots, starts,
                out, int(layer), T, Rn, B, H, S, R, dr, float(scale))
        return out
    nbs, bt = _mla_tables(name, block_tables, S, dev)
    if pool_c is None or pool_r is None:
        raise ValueError(f"{name}: block_tables need the latent and rope pools")
    pxb = (pool_c["q"] if quantized else pool_c).shape[1]
    _check_mla_plane(name, pool_c, L, pxb, bt, R, dev, quantized)
    _check_mla_plane(name, pool_r, L, pxb, bt, dr, dev, quantized)
    pools = ((pool_c["q"], pool_c["s"], pool_r["q"], pool_r["s"]) if quantized
             else (pool_c, pool_r))
    # the descriptor rows' tables, as JAX's `_ragged_tables` gathers them
    tbl = block_tables.index_select(0, slots.long()).contiguous()
    _launch(name, symbol + "_paged", qt, qr, c_self, kr_self, *planes, rowids, offsets, slots,
            starts, tbl, *pools, out, int(layer), T, Rn, B, H, S, R, dr, nbs, bt, pxb,
            float(scale))
    return out
