"""Grammar-constrained decoding (counterpart of `llm_mcp_tpu/constrain/`).

Compiles JSON-schema / regex / choice constraints into byte-level
pushdown automata (grammar.py, schema.py), lifts them to packed
per-state token bitmasks over the model vocabulary (masks.py), and
hands the engine a per-slot cursor (`SlotAutomaton`) whose masks ride
the mask-then-sample path of `ops/sampling.py`, through speculative
verify too, where per-position masks are applied before accept/reject.
numpy and the standard library only, as in the reference.

Env knobs, read at engine construction:

- ``TPU_CONSTRAIN`` (default 1): kill switch. 0 disables the whole
  subsystem: requests carrying constraints run unconstrained and no mask
  path is built.
- ``TPU_CONSTRAIN_CACHE`` (default 64): LRU entries in the per-engine
  schema compile cache.
- ``LLM_MCP_TPU_CN_BIAS_MAX`` (default 64): max ``logit_bias`` entries
  per request (the width of the bias scatter in the sampler).
"""

from __future__ import annotations

import os

from .grammar import ByteAutomaton, GrammarError
from .masks import (
    CompiledConstraint,
    ConstraintCompiler,
    SlotAutomaton,
    TokenByteTable,
    mask_words,
    spec_key,
)
from .schema import build_automaton, build_grammar

__all__ = [
    "ByteAutomaton",
    "CompiledConstraint",
    "ConstraintCompiler",
    "GrammarError",
    "SlotAutomaton",
    "TokenByteTable",
    "build_automaton",
    "build_grammar",
    "constrain_enabled",
    "mask_words",
    "spec_key",
]


def constrain_enabled() -> bool:
    """The `TPU_CONSTRAIN` kill switch, read at engine construction."""
    return os.environ.get("TPU_CONSTRAIN", "1") != "0"
