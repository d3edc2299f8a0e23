"""Token sampling: temperature / top-k / top-p with per-row parameters
(counterpart of `llm_mcp_tpu/ops/sampling.py:sample_tokens`).

Same three regimes as the JAX function, chosen per batch: all greedy rows
take the exact argmax (first index on ties); all plain-temperature rows
take an exact Gumbel-argmax over the full vocabulary; a mixed batch takes
the candidate window (top 64) with top-k / top-p inside it, greedy rows
staying greedy. The choice is made on the device with `torch.where`, so a
decode step never waits on the host. The random numbers come from an
explicit `torch.Generator`; they cannot match `jax.random`, so tests feed
the same Gumbel noise to both sides through `noise`.
"""

from __future__ import annotations

import torch

_CANDIDATES = 64


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
