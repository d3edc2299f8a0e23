"""Token sampling: temperature / top-k / top-p with per-row parameters,
the constraint mask and the speculative verify (counterpart of
`llm_mcp_tpu/ops/sampling.py`).

Same three regimes as the JAX function, chosen per batch: all greedy rows
take the exact argmax (first index on ties); all plain-temperature rows
take an exact Gumbel-argmax over the full vocabulary; a mixed batch takes
the candidate window (top 64) with top-k / top-p inside it, greedy rows
staying greedy. The choice is made on the device with `torch.where`, so a
decode step never waits on the host. The random numbers come from an
explicit `torch.Generator`; they cannot match `jax.random`, so tests feed
the same Gumbel noise to both sides through `noise`.

The candidate window is always an exact `torch.topk` (JAX takes
`lax.approx_max_k` on the TPU for V > 256 unless `exact`), so the `exact`
argument of `sample_tokens` and `spec_verify` is accepted and changes
nothing here.

`expand_mask` and `apply_token_mask` apply a grammar constraint's packed
token bitmask (`constrain/masks.py`: bit t & 31 of word t >> 5) and a
request's `logit_bias` on the device; `spec_verify` accepts or rejects a
deterministic draft against the target logits (greedy: exact argmax
equality; sampled: rejection sampling with the residual resample).
"""

from __future__ import annotations

import torch

_CANDIDATES = 64


def expand_mask(packed: torch.Tensor, V: int) -> torch.Tensor:
    """Unpack `[..., ceil(V/32)]` packed words (the uint32 bits, held in an
    int32 or int64 tensor) to a `[..., V]` bool mask: token t is bit
    t & 31 of word t >> 5, as `constrain/masks.py` packs it."""
    ids = torch.arange(V, device=packed.device)
    word = packed.long()[..., ids >> 5]
    return ((word >> (ids & 31)) & 1).bool()


def apply_token_mask(
    logits: torch.Tensor,  # [B, V] or [A, C, V]
    packed: torch.Tensor | None,  # [B, W] / [A, C, W] packed words, or None
    bias_ids: torch.Tensor | None = None,  # [B, NB] int, -1 = pad
    bias_vals: torch.Tensor | None = None,  # [B, NB] float32
) -> torch.Tensor:
    """The constraint mask and `logit_bias`, as JAX applies them: the bias
    is added first (it may reweight the legal set), then illegal tokens go
    to -inf, so a bias never brings back a masked token. Bias rows are per
    request and broadcast over the positions of 3-D verify logits; pad
    entries (id -1) add 0 at column 0."""
    V = logits.shape[-1]
    out = logits
    if bias_ids is not None and bias_vals is not None:
        B = bias_ids.shape[0]
        vals = torch.where(bias_ids >= 0, bias_vals.to(logits.dtype),
                           torch.zeros((), dtype=logits.dtype, device=logits.device))
        dense = torch.zeros((B, V), dtype=logits.dtype, device=logits.device)
        dense.scatter_add_(1, bias_ids.long().clamp(min=0), vals)
        out = out + (dense[:, None, :] if logits.dim() == 3 else dense)
    if packed is not None:
        out = out.masked_fill(~expand_mask(packed, V), float("-inf"))
    return out


def gumbel_noise(
    shape: tuple[int, ...], generator: torch.Generator | None, device
) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int (0 = disabled)
    top_p: torch.Tensor,  # [B] float (1.0 = disabled)
    active: torch.Tensor | None = None,  # [B] bool — rows whose sample matters
    noise: torch.Tensor | None = None,  # [B, V] Gumbel noise (tests)
    exact: bool = False,  # JAX's exact-window flag: the window here is always exact
) -> torch.Tensor:
    """Sample one token per row ([B] int32). temperature <= 0 → greedy.
    `active` keeps parked rows out of the regime choice, as in JAX."""
    B, V = logits.shape
    n_cand = min(_CANDIDATES, V)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=logits.device)

    def _all(cond: torch.Tensor) -> torch.Tensor:
        return torch.all(torch.where(active, cond, torch.ones_like(cond)))

    is_greedy = temperature <= 0.0
    plain_row = (top_k <= 0) & (top_p >= 1.0) & ~is_greedy
    all_greedy = _all(is_greedy)
    all_plain = _all(plain_row)
    if noise is None:
        noise = gumbel_noise((B, V), generator, logits.device)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]

    plain = torch.argmax(logits / temp + noise, dim=-1).to(torch.int32)

    cand_logits, cand_idx = torch.topk(logits, n_cand, dim=-1)  # sorted desc
    k = torch.where(top_k <= 0, n_cand, torch.clamp(top_k, max=n_cand))
    pos = torch.arange(n_cand, device=logits.device)[None, :]
    k_mask = pos < k[:, None]
    scaled = torch.where(k_mask, cand_logits / temp, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_mask = (cum - probs) < top_p.float()[:, None]
    p_mask[:, 0] = True
    final = torch.where(p_mask & k_mask, scaled, float("-inf"))
    choice = torch.argmax(final + noise[:, :n_cand], dim=-1)
    windowed = torch.gather(cand_idx, 1, choice[:, None])[:, 0].to(torch.int32)
    windowed = torch.where(is_greedy, greedy, windowed)

    return torch.where(all_greedy, greedy, torch.where(all_plain, plain, windowed))


def spec_verify(
    logits: torch.Tensor,  # [A, C, V] float32: position j scores draft offset j
    drafts: torch.Tensor,  # [A, K] int drafted tokens, K = C - 1 >= 1
    n_draft: torch.Tensor,  # [A] int valid drafts per row (<= K)
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [A]
    top_k: torch.Tensor,  # [A] int (0 = disabled)
    top_p: torch.Tensor,  # [A] float (1.0 = disabled)
    active: torch.Tensor | None = None,  # [A] bool: rows whose result matters
    exact: bool = False,  # JAX's exact-window flag: the window here is always exact
    noise: tuple | None = None,  # (u [A, K], gumbel [A, V]) (tests)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept or reject a deterministic draft against the target logits and
    sample the token that always follows (JAX's `spec_verify`).

    The drafter puts probability 1 on its proposal, so rejection sampling
    accepts draft d at position j with probability p_target(d) (greedy
    rows: exact argmax equality), stops at the first rejection and samples
    the next token from the residual: the target with the rejected token
    removed and renormalized. Its marginal is the target's, so speculation
    changes how many model calls a token costs, not which tokens come out.
    With every draft accepted the final token is a bonus sample at the
    position after the last draft.

    The same three regimes as `sample_tokens`, chosen on the device: all
    greedy rows, all plain temperature (full vocabulary), else the
    candidate window with top-k / top-p. Returns (n_acc [A] int32, final
    [A] int32): row a emits drafts[a, :n_acc[a]] then final[a]."""
    A, C, V = logits.shape
    K = C - 1
    n_cand = min(_CANDIDATES, V)
    dev = logits.device
    drafts = drafts.long()
    n_draft = n_draft.long()
    if active is None:
        active = torch.ones(A, dtype=torch.bool, device=dev)
    if noise is None:
        u = torch.rand((A, K), generator=generator, device=dev, dtype=torch.float32)
        g = gumbel_noise((A, V), generator, dev)
    else:
        u, g = noise

    def _all(cond: torch.Tensor) -> torch.Tensor:
        return torch.all(torch.where(active, cond, torch.ones_like(cond)))

    def _count(acc: torch.Tensor) -> torch.Tensor:
        # the longest accepted prefix: cumprod zeroes all past the first rejection
        return torch.cumprod(acc.long(), dim=1).sum(dim=1)

    def _at(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        # x[a, n[a]] over axis 1, whatever trails it
        idx = n.reshape(A, 1, *([1] * (x.dim() - 2))).expand(A, 1, *x.shape[2:])
        return torch.gather(x, 1, idx)[:, 0]

    def _mask_tok(n_acc: torch.Tensor) -> torch.Tensor:
        # the residual drops the first rejected draft; with none rejected
        # the final token is the bonus sample and -1 matches no id
        rej = _at(drafts, n_acc.clamp(max=K - 1))
        return torch.where(n_acc < n_draft, rej, torch.full_like(rej, -1))

    greedy_tok = torch.argmax(logits, dim=-1)  # [A, C]
    valid = torch.arange(K, device=dev)[None, :] < n_draft[:, None]
    is_greedy = temperature <= 0.0
    greedy_acc = greedy_tok[:, :K] == drafts
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None, None]

    # all greedy rows
    n_greedy = _count(greedy_acc & valid)

    # all plain temperature: the full vocabulary
    scaled = logits / temp  # [A, C, V]
    lse = torch.logsumexp(scaled, dim=-1)  # [A, C]
    d_logit = torch.gather(scaled[:, :K], 2, drafts[..., None])[..., 0]
    p_draft = torch.exp(d_logit - lse[:, :K])
    n_full = _count(torch.where(is_greedy[:, None], greedy_acc, u < p_draft) & valid)
    resid = _at(scaled, n_full).masked_fill(
        torch.arange(V, device=dev)[None, :] == _mask_tok(n_full)[:, None], float("-inf"))
    full = torch.argmax(resid + g, dim=-1)

    # the candidate window, the distribution `sample_tokens` draws from,
    # at every chunk position
    cand_logits, cand_idx = torch.topk(logits.reshape(A * C, V), n_cand, dim=-1)
    cand_logits = cand_logits.reshape(A, C, n_cand)
    cand_idx = cand_idx.reshape(A, C, n_cand)
    k = torch.where(top_k <= 0, n_cand, torch.clamp(top_k, max=n_cand)).long()
    k_mask = torch.arange(n_cand, device=dev)[None, None, :] < k[:, None, None]
    wscaled = torch.where(k_mask, cand_logits / temp, float("-inf"))
    probs = torch.softmax(wscaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_mask = (cum - probs) < top_p.float()[:, None, None]
    p_mask[:, :, 0] = True
    m = p_mask & k_mask
    wp = torch.where(m, probs, torch.zeros_like(probs))
    norm = torch.clamp(wp.sum(dim=-1), min=1e-9)  # [A, C]
    match = cand_idx[:, :K] == drafts[:, :, None]  # [A, K, n_cand]
    pw_draft = torch.where(match, wp[:, :K], torch.zeros_like(wp[:, :K])).sum(dim=-1)
    pw_draft = pw_draft / norm[:, :K]
    n_win = _count(torch.where(is_greedy[:, None], greedy_acc, u < pw_draft) & valid)
    w_scaled, w_idx, w_m = _at(wscaled, n_win), _at(cand_idx, n_win), _at(m, n_win)
    wresid = torch.where(w_m & (w_idx != _mask_tok(n_win)[:, None]), w_scaled,
                         torch.full_like(w_scaled, float("-inf")))
    choice = torch.argmax(wresid + g[:, :n_cand], dim=-1)
    window = torch.gather(w_idx, 1, choice[:, None])[:, 0]

    plain = _all((top_k <= 0) & (top_p >= 1.0))
    all_greedy = _all(is_greedy)
    n_acc = torch.where(all_greedy, n_greedy, torch.where(plain, n_full, n_win))
    sampled = torch.where(plain, full, window)
    final = torch.where(is_greedy, _at(greedy_tok, n_acc), sampled)
    final = torch.where(all_greedy, _at(greedy_tok, n_greedy), final)
    return n_acc.to(torch.int32), final.to(torch.int32)
