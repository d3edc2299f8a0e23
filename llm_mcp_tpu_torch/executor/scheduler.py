"""Token-budget prefill/decode scheduler (counterpart of
`llm_mcp_tpu/executor/scheduler.py:TokenBudgetScheduler`).

The engine loop asks `decide()` once per iteration for a prefill token
budget, stages that many prompt tokens from mid-prefill slots, and runs
them beside the decode round, so decode cadence never stalls behind a
prefill backlog. Per round with active decode slots:

  fair_cap = decode_round_s / prefill_tok_s   (≈ one decode round of prefill)
  need     = backlog_tokens / rounds_until_deadline   (oldest prompt's TTFT)
  budget   = clamp(need, min_budget, fair_cap)

With no active decode slot the budget is the whole backlog. Both cost
terms are EMAs of measured dispatches: plain rounds feed the decode term,
standalone groups the prefill term, and a round that carried a group
feeds the prefill term with its time over the decode term
(`observe_fused`); a speculative verify round feeds the prefill term too
(`observe_verify`: it runs the chunk machinery), and its tokens come out
of that iteration's budget (`decide(reserved_tokens=)`). The same
decode term prices the API's shed path (`drain_estimate_s`, the
Retry-After of a 429). Tenant quotas and the
flight recorder hooks of the JAX scheduler come with tenancy and
telemetry, in later slices.
"""

from __future__ import annotations

import math

_EMA = 0.7  # keep-fraction


class TokenBudgetScheduler:
    def __init__(
        self,
        *,
        target_ttft_ms: float = 2000.0,
        min_budget: int = 64,
        decode_seed_s: float = 0.05,
        prefill_tok_seed_s: float = 1e-4,
    ):
        self.target_ttft_s = max(1.0, float(target_ttft_ms)) / 1000.0
        self.min_budget = max(1, int(min_budget))
        self.decode_round_s = float(decode_seed_s)
        self.prefill_tok_s = float(prefill_tok_seed_s)
        self.pad_waste = 0.0  # EMA of per-dispatch waste fraction
        self.verify_rounds = 0
        self.verify_tokens = 0

    def observe_decode(self, round_s: float) -> None:
        """A prefill-free decode round's wall time (dispatch to fetch)."""
        if round_s > 0:
            self.decode_round_s = _EMA * self.decode_round_s + (1 - _EMA) * round_s

    def observe_prefill(self, tokens: int, seconds: float, padded_tokens: int = 0) -> None:
        """A standalone chunk dispatch: `tokens` true prompt tokens in
        `seconds`, `padded_tokens` the dispatched shape (≥ tokens)."""
        if tokens <= 0 or seconds <= 0:
            return
        comp = max(int(tokens), int(padded_tokens))
        per = min(1.0, max(1e-8, seconds / comp))
        self.prefill_tok_s = _EMA * self.prefill_tok_s + (1 - _EMA) * per
        self.pad_waste = _EMA * self.pad_waste + (1 - _EMA) * (1.0 - tokens / comp)

    def observe_fused(self, round_s: float, prefill_tokens: int, padded_tokens: int = 0) -> None:
        """A fused round: attribute the time over the decode EMA to its
        prefill tokens. Rounds faster than the EMA teach nothing (the
        residual would be negative)."""
        extra = round_s - self.decode_round_s
        if prefill_tokens > 0 and extra > 0:
            self.observe_prefill(prefill_tokens, extra, padded_tokens=padded_tokens)

    def observe_verify(self, tokens: int, seconds: float) -> None:
        """A speculative verify round: `tokens` chunk positions (each row's
        base token and drafts) in `seconds`, priced like prompt tokens."""
        self.verify_rounds += 1
        self.verify_tokens += max(0, int(tokens))
        self.observe_prefill(tokens, seconds)

    def fair_cap(self) -> int:
        cap = self.decode_round_s / self.prefill_tok_s
        cap *= max(0.0, 1.0 - self.pad_waste)
        return max(self.min_budget, int(cap))

    def decide(self, backlog_tokens: int, n_active: int, oldest_wait_s: float,
               reserved_tokens: int = 0) -> int:
        """Prefill token budget for the next engine iteration.
        `reserved_tokens`: chunk positions this iteration already owes a
        verify round; they come out of the budget, which may drop to 0."""
        if backlog_tokens <= 0:
            return 0
        if n_active == 0:
            return backlog_tokens
        headroom_s = max(self.target_ttft_s - oldest_wait_s, self.decode_round_s)
        rounds_left = max(1.0, headroom_s / max(self.decode_round_s, 1e-6))
        need = int(math.ceil(backlog_tokens / rounds_left))
        budget = max(self.min_budget, min(need, self.fair_cap()))
        if reserved_tokens > 0:
            budget = max(0, budget - int(reserved_tokens))
        return budget

    def drain_estimate_s(
        self,
        n_waiting: int,
        mean_tokens: float,
        decode_chunk: int,
        max_slots: int,
    ) -> float:
        """Seconds until `n_waiting` queued requests could start, from the
        decode round EMA: waves of `max_slots` requests, each running
        `mean_tokens / decode_chunk` rounds. The Retry-After of a 429."""
        waves = math.ceil(max(1, int(n_waiting)) / max(1, int(max_slots)))
        rounds = max(1.0, float(mean_tokens) / max(1, int(decode_chunk)))
        round_s = self.decode_round_s if self.decode_round_s > 0 else 0.05
        return waves * rounds * round_s
