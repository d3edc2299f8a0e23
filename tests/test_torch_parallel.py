"""The port's tensor parallelism (`llm_mcp_tpu_torch/parallel/`, the model
under tp and the engine over a tp mesh) against the JAX package, on the
CPU.

  - `mesh_axis_sizes` equals JAX's, errors included; the spec tables
    (`llama_param_specs`, `quantized_specs`, `kv_cache_specs`,
    `kv_pool_specs`) equal JAX's PartitionSpecs for the tiny configs and
    every Llama-family config of the catalog, from the configs alone;
  - each rank's slice of a `tiny-llm` tree (f32 and int8, unfused) equals
    the addressable shard of JAX's `shard_pytree` on the same device of
    `make_mesh("tp=2")` and `make_mesh("tp=4")`;
  - the collectives over `gloo` (ranks as threads, each with its own
    `ProcessGroupGloo` over one store): sums, maxima, gathers, and the
    fused int8 cache's heads cut and regathered bit for bit; the row-split
    w8a8 product, the vocab-parallel embedding and the gathered logits
    equal the one-device ones bit for bit, and a rank-local absmax does
    not;
  - the engine at tp=2 over `gloo` gives the greedy text and usage of
    JAX's engine on `make_mesh("tp=2")` and of a mesh-less JAX engine, in
    f32 and at int8 weights with the int8 cache, through admission,
    ragged chunks, prefix hits, verify rounds and the paged pool; four
    requests sent at once: a mesh-less engine replaying the leader's steps
    gets every op's result the leader got, and the follower stays in step;
    sampled tokens at temperature 0.8 leave both ranks' token rings equal;
    the refusals of this slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from llm_mcp_tpu.executor import GenerationEngine as JaxEngine
from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models import quant as JQ
from llm_mcp_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu.parallel import mesh as jmesh
from llm_mcp_tpu.parallel import sharding as jsharding
from llm_mcp_tpu_torch.executor import GenerationEngine, SliceEngine
from llm_mcp_tpu_torch.executor.dispatch import GSPMDBackend
from llm_mcp_tpu_torch.models import quant as TQ
from llm_mcp_tpu_torch.models.configs import MODEL_CONFIGS, get_config
from llm_mcp_tpu_torch.models.llama import fuse_prompt_kv
from llm_mcp_tpu_torch.models.weights import params_from_numpy
from llm_mcp_tpu_torch.parallel import mesh as tmesh
from llm_mcp_tpu_torch.parallel import sharding as tsharding


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_mesh(spec: str, rank: int, world: int) -> tmesh.Mesh:
    """A rank's mesh without process groups: enough for slicing and for
    the engine's refusals, which run before any collective."""
    return tmesh.Mesh(tmesh.mesh_axis_sizes(spec, world), rank, torch.device("cpu"), {})


def gloo_groups(n: int, timeout_s: float = 60.0) -> list:
    """n `ProcessGroupGloo`s over one store, built together (their
    constructors rendezvous), one a rank."""
    store = dist.HashStore()
    pgs: list = [None] * n

    def mk(r: int) -> None:
        pgs[r] = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), r, n,
                                       datetime.timedelta(seconds=timeout_s))

    ts = [threading.Thread(target=mk, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return pgs


def on_ranks(n: int, fn, spec: str = "", timeout_s: float = 60.0) -> list:
    """fn(mesh) on n CPU ranks in threads; their results, in rank order."""
    pgs = gloo_groups(n, timeout_s)
    out: list = [None] * n
    errs: list = []

    def run(r: int) -> None:
        try:
            m = tmesh.make_mesh(spec or f"tp={n}", device="cpu", group=pgs[r],
                                timeout_s=timeout_s)
            with tmesh.tp_scope(m):
                out[r] = fn(m)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if errs:
        raise errs[0]
    return out


@contextlib.contextmanager
def tp_engines(model, params, tp: int = 2, timeout_s: float = 60.0, engine_cls=None, **kw):
    """tp engines over `gloo` in this process: rank 0 leads (started), the
    others replay its steps in threads (`run_follower`). Yields the engines
    in rank order; on exit the leader shuts down and the followers end on
    its stop frame."""
    pgs = gloo_groups(tp, timeout_s)
    addr = f"127.0.0.1:{_free_port()}"
    engs = []
    for r in range(tp):
        m = tmesh.make_mesh(f"tp={tp}", device="cpu", group=pgs[r], timeout_s=timeout_s)
        if engine_cls is SliceEngine:
            engs.append(SliceEngine(model, mesh=m, cmd_addr=addr, device="cpu", params=params,
                                    **kw))
        else:
            engs.append(GenerationEngine(model, params=params, mesh=m, device="cpu",
                                         backend=GSPMDBackend(addr, world_size=tp), **kw))
    def follow(eng) -> None:
        try:
            eng.run_follower()
        except Exception:  # a follower made to die; the leader's side is the test's
            pass

    fols = [threading.Thread(target=follow, args=(e,), daemon=True) for e in engs[1:]]
    for t in fols:
        t.start()
    engs[0].start()
    try:
        yield engs
    finally:
        engs[0].shutdown()
        for t in fols:
            t.join(60)


def settle(lead, *fols, timeout_s: float = 60.0) -> None:
    """Wait until every follower has replayed each step the leader emitted
    (a follower counts a step once its op returned)."""
    import time

    want = sum(lead._backend.counts.values())
    deadline = time.monotonic() + timeout_s
    while any(sum(f._backend.counts.values()) < want for f in fols):
        assert time.monotonic() < deadline, "a follower fell behind"
        time.sleep(0.01)


def jax_tree(quant: bool, seed: int = 3):
    """One unfused `tiny-llm` tree: JAX's (f32, or direct int8 with f32
    scales) and the port's conversion of it."""
    jcfg = jax_get_config("tiny-llm")
    if quant:
        jp = JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(seed), scale_dtype=jnp.float32)
    else:
        jp = JL.init_llama_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), get_config("tiny-llm"), "cpu",
                           torch.float32)
    return jp, tp


def _spec_tuple(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuple(v) for k, v in tree.items()}
    return tuple(tree)


# -- the mesh and the specs ---------------------------------------------------------


@pytest.mark.parametrize("spec,n", [
    ("", 8), ("", 1), ("tp=2", 2), ("dp=2,tp=4", 8), ("pp=2,tp=2", 4), ("dp=2,sp=2,tp=2", 8),
    (" tp = 4 ", 4), ("ep=2,bogus=3,tp=2", 4), ("tp=2", 8), ("dp=3", 2), ("tp=", 2),
])
def test_mesh_axis_sizes_match_jax(spec, n):
    try:
        want = jmesh.mesh_axis_sizes(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_axis_sizes(spec, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.mesh_axis_sizes(spec, n) == want
    assert tuple(want) == tmesh.AXES == jmesh.AXES


LLAMA_FAMILY = sorted(n for n, c in JAX_CONFIGS.items() if c.arch == "llama" and n in MODEL_CONFIGS)


@pytest.mark.parametrize("name", LLAMA_FAMILY + ["tiny-v2", "tiny-mla"])
def test_param_specs_match_jax(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    want = _spec_tuple(jsharding.llama_param_specs(jcfg))
    got = tsharding.llama_param_specs(cfg)
    assert got == want
    assert TQ.quantized_specs(got) == _spec_tuple(
        JQ.quantized_specs(jsharding.llama_param_specs(jcfg)))


@pytest.mark.parametrize("quantized,latent", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_cache_and_pool_specs_match_jax(quantized, latent):
    assert tsharding.kv_cache_specs(quantized, latent) == _spec_tuple(
        jsharding.kv_cache_specs(quantized=quantized, latent=latent))
    assert tsharding.kv_pool_specs(quantized, latent) == _spec_tuple(
        jsharding.kv_pool_specs(quantized=quantized, latent=latent))


# -- the slices ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_rank_slices_match_jax_shards(tp, quant):
    jp, tree = jax_tree(quant)
    jcfg = jax_get_config("tiny-llm")
    specs = jsharding.llama_param_specs(jcfg)
    if quant:
        specs = JQ.quantized_specs(specs)
    jm = jmesh.make_mesh(f"tp={tp}", devices=jax.devices()[:tp])
    placed = jsharding.shard_pytree(jp, specs, jm)
    devs = list(jm.devices.flat)
    for r in range(tp):
        mine = tsharding.shard_tree_for(get_config("tiny-llm"), tree, rank_mesh(f"tp={tp}", r, tp))
        flat_j = jax.tree_util.tree_leaves_with_path(placed)
        for path, leaf in flat_j:
            node = mine
            for k in path:
                node = node[k.key]
            shard = next(s for s in leaf.addressable_shards if s.device == devs[r])
            want = np.asarray(shard.data)
            got = node.numpy()
            assert got.shape == want.shape, (path, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_fused_tree_is_refused_under_tp():
    _, tree = jax_tree(True)
    with pytest.raises(ValueError, match="fused"):
        tsharding.shard_tree_for(get_config("tiny-llm"), TQ.fuse_layer_weights(dict(tree)),
                                 rank_mesh("tp=2", 0, 2))


# -- the collectives over gloo ---------------------------------------------------------


def test_collectives_over_gloo_threads():
    def fn(m):
        r = m.tp_rank
        s = m.all_reduce(torch.tensor([1.0 + r, 2.0], dtype=torch.bfloat16), "sum")
        mx = m.all_reduce(torch.tensor([r, 7 - r], dtype=torch.int32), "max")
        g = m.all_gather(torch.full((2, 1), float(r)), dim=-1)
        return s, mx, g, dict(m.stats)

    outs = on_ranks(3, fn)
    for s, mx, g, st in outs:
        assert s.dtype == torch.bfloat16 and s.tolist() == [6.0, 6.0]
        assert mx.tolist() == [2, 7]
        assert g.tolist() == [[0.0, 1.0, 2.0]] * 2
        assert st["all_reduce"] == 2 and st["all_gather"] == 1 and st["seconds"] > 0


def test_fused_heads_cut_and_regather_bit_for_bit():
    cfg = get_config("tiny-llm")
    L, Hkv, hd, T = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim, 9
    g = torch.Generator().manual_seed(0)
    k = torch.randn((L, 1, Hkv, T, hd), generator=g)
    v = torch.randn((L, 1, Hkv, T, hd), generator=g)
    full = fuse_prompt_kv(k, v)

    def fn(m):
        r, hl = m.tp_rank, Hkv // m.tp
        local = tsharding.fused_heads_local(full, Hkv, m)
        own = fuse_prompt_kv(k[:, :, r * hl:(r + 1) * hl], v[:, :, r * hl:(r + 1) * hl])
        back = tsharding.fused_heads_full(local, m)
        plain = tsharding.fused_heads_full(tsharding.fused_heads_local(k, Hkv, m), m)
        return local, own, back, plain

    for local, own, back, plain in on_ranks(2, fn):
        for key in ("q", "s"):
            assert torch.equal(local[key], own[key])
            assert torch.equal(back[key], full[key])
        assert torch.equal(plain, k)


def test_row_split_products_equal_one_device():
    """w8a8 `qdot_rows` on each rank's rows equals `qdot` on the whole
    (the absmax MAX over tp, then the exact int32 sum); the rank's own
    absmax gives other int8 rows. The vocab-parallel embedding and the
    gathered logits are exact; float row products are summed in float32."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 64), generator=g) * torch.linspace(0.1, 3.0, 64)
    w = TQ.quantize_weight(torch.randn((64, 48), generator=g))
    wf = torch.randn((64, 48), generator=g)
    emb = TQ.quantize_weight(torch.randn((32, 16), generator=g), axis=-1)
    h = torch.randn((3, 16), generator=g)
    ids = torch.tensor([[0, 17, 31], [16, 15, 3]], dtype=torch.int32)
    want = TQ.qdot(x, w)

    def fn(m):
        r = m.tp_rank
        xr = x[:, r * 32:(r + 1) * 32]
        wr = {"q": w["q"][r * 32:(r + 1) * 32], "s": w["s"]}
        got = TQ.qdot_rows(xr, wr)
        with tmesh.tp_scope(None):
            local = TQ.qdot(xr, wr)  # the rank's own absmax, no sum
        er = {"q": emb["q"][r * 16:(r + 1) * 16], "s": emb["s"][r * 16:(r + 1) * 16]}
        return (got, local, TQ.qdot_rows(xr, wf[r * 32:(r + 1) * 32]),
                TQ.embed_lookup_tp(er, ids), TQ.logits_head_tp(er, h, tied=True))

    for got, local, fl, e, lg in on_ranks(2, fn):
        assert torch.equal(got, want)
        assert not torch.equal(local, want)
        torch.testing.assert_close(fl, x @ wf, atol=1e-5, rtol=1e-5)
        assert torch.equal(e, TQ.embed_lookup(emb, ids))
        assert torch.equal(lg, TQ.logits_head(emb, h, tied=True))


# -- the engine at tp=2 against JAX's -----------------------------------------------

MID = "pin this shared preamble across the process boundary now "
REPETITIVE = ("repeat this exact list again and again: alpha beta gamma delta "
              "alpha beta gamma delta alpha beta gamma delta")
TRAFFIC = [
    ("admission check", 8),  # whole-prompt admission
    (REPETITIVE, 40),        # ragged chunks, then verify rounds
    (REPETITIVE, 40),        # second sight: the prefix stores into the pool
    (REPETITIVE, 12),        # third sight: an aligned hit, pinned
    (MID, 6),
    (MID, 6),                # stores 32 tokens (unaligned)
    (MID, 6),                # the hit copies its boundary block on write
]
ENGINE_KW = dict(max_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=32,
                 prompt_cache_mb=64, seed=3)


def _serve(eng, traffic) -> list:
    return [eng.generate(p, max_tokens=n, temperature=0.0) for p, n in traffic]


@pytest.mark.parametrize("quant", ["", "int8"])
def test_tp2_engine_matches_jax_tp2_and_meshless(monkeypatch, quant):
    for knob in ("TPU_SPEC", "TPU_PAGED_PHYSICAL", "TPU_KV_BLOCK_TOKENS", "TPU_PIPELINE_DEPTH"):
        monkeypatch.delenv(knob, raising=False)
    jp, tree = jax_tree(bool(quant))
    kw = dict(ENGINE_KW, quant=quant, kv_quant=quant)
    outs = {}
    for name, mesh in (("jax", None), ("jax_tp2", jmesh.make_mesh("tp=2", devices=jax.devices()[:2]))):
        je = JaxEngine("tiny-llm", params=jp, mesh=mesh, dtype=jnp.float32, **kw)
        je.start()
        try:
            outs[name] = _serve(je, TRAFFIC)
        finally:
            je.shutdown()
    with tp_engines("tiny-llm", tree, dtype=torch.float32, **kw) as (lead, fol):
        assert lead._tp is not None and lead._phys is not None and not lead.cuda_graphs
        assert lead._mcfg.n_heads == 2 and lead._mcfg.n_kv_heads == 1
        got = _serve(lead, TRAFFIC)
        assert not lead.dead
        assert lead.prefix_cache_hits >= 2 and lead.speculation_stats()["verify_calls"] > 0
        emitted = dict(lead._backend.counts)
        settle(lead, fol)
        assert torch.equal(lead._d_last, fol._d_last)
    replayed = dict(fol._backend.counts)
    assert emitted == replayed
    for op in ("admit", "ragged", "bsample", "decode", "verify", "pput", "cow"):
        assert emitted.get(op, 0) > 0, (op, emitted)
    for i, (p, _) in enumerate(TRAFFIC):
        for name in ("jax", "jax_tp2"):
            assert got[i]["text"] == outs[name][i]["text"], (name, p)
            assert got[i]["usage"] == outs[name][i]["usage"], (name, p)


CONCURRENT = [
    (REPETITIVE, 24),           # ragged chunks riding the others' decode rounds
    ("four rows at once", 20),
    ("decode beside a prefill", 16),
    ("the last of the four", 12),
]


def _host(x):
    """An op's result as host copies (tensors cloned, tuples and dicts
    walked), taken as it returns: later rounds reuse the buffers."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _assert_same(got, want, where) -> None:
    """Integer results equal; float results within float32 row-split
    rounding (tp sums partial products across ranks)."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.shape == want.shape, where
        if want.is_floating_point():
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=str(where))
        else:
            assert torch.equal(got, want), where
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, (*where, i))
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], (*where, k))
    else:
        assert got == want, where


@pytest.mark.parametrize("quant", ["", "int8"])
def test_tp2_concurrent_requests_match_meshless(monkeypatch, quant):
    """Four greedy requests sent at once to two tp ranks: decode rounds
    over several live rows, chunks riding a decode round, rounds in flight
    during admission. Their schedule follows arrival times and the
    scheduler's timed budget, and a chunk's boundary changes an int8
    cache's numbers (its own keys are bf16, earlier chunks' are read back
    as int8), so a mesh-less engine serving the same prompts need not
    batch alike. The reference is a mesh-less engine replaying the
    leader's own steps, as a follower does: every op's result equals the
    leader's, so each text is the one a single device gives on that
    schedule. The follower's token ring equals the leader's, and it
    replays every op emitted."""
    import pickle

    for knob in ("TPU_SPEC", "TPU_PAGED_PHYSICAL", "TPU_KV_BLOCK_TOKENS", "TPU_PIPELINE_DEPTH"):
        monkeypatch.delenv(knob, raising=False)
    _, tree = jax_tree(bool(quant))
    kw = dict(ENGINE_KW, max_slots=4, quant=quant, kv_quant=quant, dtype=torch.float32)
    with tp_engines("tiny-llm", tree, **kw) as (lead, fol):
        steps: list = []  # (op, payload, the leader's result, live decode rows)
        emit, dx = lead._backend.emit, lead._dx

        def recorded_emit(op, args, emit=emit):
            emit(op, args)
            steps.append([op, pickle.loads(pickle.dumps(args))])

        def recorded_dx(op, *args, dx=dx):
            out = dx(op, *args)
            steps[-1] += [_host(out), lead._last_active_n if op == "decode" else None]
            return out

        lead._backend.emit, lead._dx = recorded_emit, recorded_dx
        got: list = [None] * len(CONCURRENT)
        go = threading.Barrier(len(CONCURRENT))

        def ask(i: int, prompt: str, n: int) -> None:
            go.wait(30)
            got[i] = lead.generate(prompt, max_tokens=n, temperature=0.0)

        ts = [threading.Thread(target=ask, args=(i, p, n)) for i, (p, n) in enumerate(CONCURRENT)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not lead.dead
        emitted = dict(lead._backend.counts)
        settle(lead, fol)
        assert torch.equal(lead._d_last, fol._d_last)
    assert dict(fol._backend.counts) == emitted
    for i, (p, n) in enumerate(CONCURRENT):
        assert got[i]["usage"]["completion_tokens"] >= 1, p
    ops = [st[0] for st in steps]
    assert max(st[3] or 0 for st in steps) >= 2, ops  # decode rounds over several live rows
    first_decode = ops.index("decode")
    assert "ragged" in ops[first_decode:], ops  # chunks after decoding began
    one = GenerationEngine("tiny-llm", params=tree, device="cpu", **kw)  # never started
    with torch.inference_mode():
        for i, (op, args, want, _) in enumerate(steps):
            _assert_same(_host(one._ops[op](*args)), want, (i, op))
    assert torch.equal(one._d_last, lead._d_last)


def test_tp2_sampled_rings_stay_equal():
    """Sampled traffic at temperature 0.8: every rank samples from the
    same gathered logits with a generator kept in step, so the follower's
    token ring and sampling rows equal the leader's after every request
    (else the next step parts)."""
    _, tree = jax_tree(False)
    with tp_engines("tiny-llm", tree, dtype=torch.float32, **ENGINE_KW) as (lead, fol):
        for i in range(3):
            out = lead.generate(f"sampled request {i}", max_tokens=12, temperature=0.8, top_k=20)
            assert out["usage"]["completion_tokens"] >= 1
            settle(lead, fol)
            for a, b in ((lead._d_last, fol._d_last), (lead._d_temp, fol._d_temp),
                         (lead._d_topk, fol._d_topk)):
                assert torch.equal(a, b)
        assert lead._gen.get_state().equal(fol._gen.get_state())


# -- the refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("model,spec,world,match", [
    ("tiny-llm", "dp=2", 2, "dp=2"),
    ("tiny-llm", "pp=2", 2, "pp=2"),
    ("tiny-llm", "sp=2", 2, "sp=2"),
    ("tiny-llm", "ep=2", 2, "ep=2"),
    ("tiny-v2", "tp=2", 2, "MLA and MoE"),
    ("tiny-mla", "tp=2", 2, "MLA and MoE"),
    ("tiny-moe", "tp=2", 2, "MLA and MoE"),
    ("tiny-llm", "tp=4", 4, "n_kv_heads 2"),
    ("odd-vocab", "tp=2", 2, "vocab_size 511"),
])
def test_engine_refuses_what_this_slice_lacks(model, spec, world, match):
    cfg = (dataclasses.replace(get_config("tiny-llm"), name="odd-vocab", vocab_size=511)
           if model == "odd-vocab" else model)
    with pytest.raises(ValueError, match=match) as e:
        GenerationEngine(cfg, mesh=rank_mesh(spec, 0, world), device="cpu", max_seq_len=64,
                         backend=GSPMDBackend("127.0.0.1:0", world_size=world),
                         dtype=torch.float32)
    if spec.split("=")[0] != "tp" or "MLA" in match:
        assert "ROADMAP.md queue 1 item 11" in str(e.value)


def test_engine_refuses_a_multi_rank_mesh_without_the_leader_follower_backend():
    with pytest.raises(ValueError, match="leader/follower"):
        GenerationEngine("tiny-llm", mesh=rank_mesh("tp=2", 0, 2), device="cpu", max_seq_len=64)
    with pytest.raises(ValueError, match="requires a mesh"):
        GenerationEngine("tiny-llm", device="cpu", max_seq_len=64,
                         backend=GSPMDBackend("127.0.0.1:0", world_size=1))
    with pytest.raises(ValueError, match="must divide over dp=2"):
        SliceEngine("tiny-llm", mesh=rank_mesh("dp=2", 0, 2), cmd_addr="127.0.0.1:0",
                    max_slots=3, device="cpu")
