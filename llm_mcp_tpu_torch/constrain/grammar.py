"""Byte-level grammar automaton: the constraint subsystem's core formalism
(the port's copy of `llm_mcp_tpu/constrain/grammar.py`, unchanged in
behaviour: the automata accept and reject exactly what the reference's do).

A constraint — JSON schema, regex subset, literal choice list — compiles
down to ONE shared representation: a context-free grammar over BYTES,
walked by a pushdown automaton whose configurations are interned into
integer states. Working at the byte level (not characters, not tokens)
is what makes the token-mask layer (masks.py) tokenizer-agnostic: a
token is legal in a state iff its UTF-8 bytes drive the automaton
through live states, whatever the tokenizer's segmentation.

Representation:

- a grammar is ``rules: {name: (alternative, ...)}`` where an
  alternative is a tuple of symbols and a symbol is either
  ``("t", frozenset_of_byte_values)`` (terminal byte class) or
  ``("r", rule_name)`` (rule reference). Repetition is expressed by
  RIGHT recursion (``R: [] | [x, R]``) — left recursion would loop the
  closure and is rejected.
- an automaton configuration is a STACK of frames ``(rule, alt, dot)``;
  a state is a frozenset of closure-normalized stacks. The empty stack
  in a state means the input so far is a complete sentence (accepting —
  the EOS bit in the token mask). States are interned to dense ints and
  byte transitions are memoized, so agent loops re-walking the same
  schema pay the closure cost once per distinct state.

Pure stdlib by design: the automaton advances on the engine host thread,
and the API layer compiles specs before any device work exists.
"""

from __future__ import annotations

Sym = tuple  # ("t", frozenset[int]) | ("r", str)
Alt = tuple  # tuple[Sym, ...]

# interning cap: a pathological grammar (huge enum cross-products) must
# fail compilation loudly instead of eating the serve host's RAM
MAX_STATES = 50_000


class GrammarError(ValueError):
    """Unsupported or malformed constraint spec (API surfaces this as 400)."""


def _check_rules(rules: dict) -> None:
    for name, alts in rules.items():
        for alt in alts:
            for sym in alt:
                if sym[0] == "r" and sym[1] not in rules:
                    raise GrammarError(
                        f"rule {name!r} references undefined rule {sym[1]!r}"
                    )


class ByteAutomaton:
    """Pushdown walker over a byte grammar with interned states.

    ``start_state`` is always 0. ``step(sid, byte)`` returns the next
    state id or -1 (dead). ``accepting(sid)`` is True when the bytes so
    far form a complete sentence of the grammar."""

    def __init__(self, rules: dict[str, tuple[Alt, ...]], start: str):
        _check_rules(rules)
        if start not in rules:
            raise GrammarError(f"start rule {start!r} undefined")
        self.rules = rules
        self.start = start
        self._states: list[frozenset] = []
        self._ids: dict[frozenset, int] = {}
        self._step: dict[tuple[int, int], int] = {}
        init: set[tuple] = set()
        for ai in range(len(rules[start])):
            self._close(((start, ai, 0),), init, set())
        self._intern(frozenset(init))  # state 0

    # -- closure ------------------------------------------------------------

    def _close(self, stack: tuple, out: set, seen: set) -> None:
        """Expand one stack until its top symbol is a terminal (emit) or
        the stack empties (emit () — accepting). ``seen`` guards nullable
        cycles; genuinely left-recursive grammars are rejected here."""
        if stack in seen:
            return
        seen.add(stack)
        if not stack:
            out.add(())
            return
        rule, ai, dot = stack[-1]
        alt = self.rules[rule][ai]
        if dot >= len(alt):
            # completed frame: pop, advance the parent past its rule-ref
            parent = stack[:-1]
            if not parent:
                out.add(())
                return
            pr, pa, pd = parent[-1]
            self._close(parent[:-1] + ((pr, pa, pd + 1),), out, seen)
            return
        sym = alt[dot]
        if sym[0] == "t":
            out.add(stack)
            return
        sub = sym[1]
        for ai2 in range(len(self.rules[sub])):
            self._close(stack + ((sub, ai2, 0),), out, seen)

    def _intern(self, state: frozenset) -> int:
        sid = self._ids.get(state)
        if sid is None:
            if len(self._states) >= MAX_STATES:
                raise GrammarError(
                    f"constraint automaton exceeded {MAX_STATES} states"
                )
            sid = len(self._states)
            self._states.append(state)
            self._ids[state] = sid
        return sid

    # -- walking ------------------------------------------------------------

    @property
    def start_state(self) -> int:
        return 0

    def accepting(self, sid: int) -> bool:
        return sid >= 0 and () in self._states[sid]

    def step(self, sid: int, byte: int) -> int:
        """Next state id after consuming ``byte``, or -1 (dead)."""
        if sid < 0:
            return -1
        key = (sid, byte)
        nxt = self._step.get(key)
        if nxt is not None:
            return nxt
        out: set[tuple] = set()
        seen: set[tuple] = set()
        for stack in self._states[sid]:
            if not stack:
                continue  # acceptance is not a continuation
            rule, ai, dot = stack[-1]
            sym = self.rules[rule][ai][dot]
            if byte in sym[1]:
                self._close(
                    stack[:-1] + ((rule, ai, dot + 1),), out, seen
                )
        nxt = self._intern(frozenset(out)) if out else -1
        self._step[key] = nxt
        return nxt

    def step_bytes(self, sid: int, data: bytes) -> int:
        for b in data:
            sid = self.step(sid, b)
            if sid < 0:
                return -1
        return sid

    def live_bytes(self, sid: int) -> frozenset[int]:
        """The union of byte classes the state can consume — the trie
        walk in masks.py prunes children outside this set up front."""
        if sid < 0:
            return frozenset()
        out: set[int] = set()
        for stack in self._states[sid]:
            if not stack:
                continue
            rule, ai, dot = stack[-1]
            out |= self.rules[rule][ai][dot][1]
        return frozenset(out)

    def n_states(self) -> int:
        return len(self._states)


# ---------------------------------------------------------------------------
# grammar construction helpers (shared by schema.py and the regex compiler)
# ---------------------------------------------------------------------------


def t(byte_set) -> Sym:
    return ("t", frozenset(byte_set))


def lit(text: str | bytes) -> Alt:
    """A literal byte sequence as a symbol tuple."""
    data = text.encode("utf-8") if isinstance(text, str) else text
    return tuple(("t", frozenset((b,))) for b in data)


class RuleBuilder:
    """Gensym'd rule accumulation — every compiler in the subsystem
    funnels through one of these so rule names never collide."""

    def __init__(self, prefix: str = "g"):
        self.rules: dict[str, tuple[Alt, ...]] = {}
        self._prefix = prefix
        self._n = 0

    def fresh(self) -> str:
        self._n += 1
        return f"{self._prefix}{self._n}"

    def add(self, name: str, alts: list[Alt]) -> str:
        self.rules[name] = tuple(tuple(a) for a in alts)
        return name

    def rule(self, alts: list[Alt]) -> str:
        return self.add(self.fresh(), alts)

    def star(self, seq: Alt) -> str:
        """R: [] | [seq..., R] — right-recursive Kleene star."""
        name = self.fresh()
        self.rules[name] = ((), tuple(seq) + (("r", name),))
        return name


# ---------------------------------------------------------------------------
# regex subset → grammar
# ---------------------------------------------------------------------------

_CLASS_ESCAPES = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(
        list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
        + list(range(0x61, 0x7B)) + [0x5F]
    ),
    "s": frozenset((0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B)),
    "n": frozenset((0x0A,)),
    "t": frozenset((0x09,)),
    "r": frozenset((0x0D,)),
}
_ANY = frozenset(b for b in range(256) if b != 0x0A)


class _RegexParser:
    """Recursive-descent compiler for the supported regex subset:
    literals, ``.``, ``[...]`` classes (ranges, negation), ``(...)``
    groups, ``|`` alternation, ``* + ?`` and ``{m}/{m,}/{m,n}``
    quantifiers, and the ``\\d \\w \\s \\n \\t \\r`` escapes. Anchors and
    backreferences are rejected — the automaton always full-matches."""

    def __init__(self, pattern: str, rb: RuleBuilder):
        self.p = pattern
        self.i = 0
        self.rb = rb

    def _err(self, msg: str) -> GrammarError:
        return GrammarError(f"regex: {msg} at offset {self.i} in {self.p!r}")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def parse(self) -> str:
        name = self._alternation()
        if self.i != len(self.p):
            raise self._err(f"unexpected {self.peek()!r}")
        return name

    def _alternation(self) -> str:
        branches = [self._concat()]
        while self.peek() == "|":
            self.i += 1
            branches.append(self._concat())
        return self.rb.rule([(("r", b),) for b in branches])

    def _concat(self) -> str:
        syms: list[Sym] = []
        while self.peek() not in ("", "|", ")"):
            syms.extend(self._quantified())
        return self.rb.rule([tuple(syms)])

    def _quantified(self) -> list[Sym]:
        atom = self._atom()
        ch = self.peek()
        if ch == "*":
            self.i += 1
            return [("r", self.rb.star(atom))]
        if ch == "+":
            self.i += 1
            return list(atom) + [("r", self.rb.star(atom))]
        if ch == "?":
            self.i += 1
            return [("r", self.rb.rule([(), tuple(atom)]))]
        if ch == "{":
            end = self.p.find("}", self.i)
            if end == -1:
                raise self._err("unterminated {m,n}")
            body = self.p[self.i + 1 : end]
            self.i = end + 1
            try:
                if "," not in body:
                    lo = hi = int(body)
                elif body.endswith(","):
                    lo, hi = int(body[:-1]), -1
                else:
                    a, b = body.split(",", 1)
                    lo, hi = int(a), int(b)
            except ValueError:
                raise self._err(f"bad repetition {{{body}}}") from None
            if lo < 0 or (hi != -1 and hi < lo) or lo > 256:
                raise self._err(f"bad repetition bounds {{{body}}}")
            syms: list[Sym] = []
            for _ in range(lo):
                syms.extend(atom)
            if hi == -1:
                syms.append(("r", self.rb.star(atom)))
            else:
                opt = self.rb.rule([(), tuple(atom)])
                syms.extend([("r", opt)] * (hi - lo))
            return syms
        return list(atom)

    def _atom(self) -> Alt:
        ch = self.peek()
        if ch == "":
            raise self._err("dangling quantifier or empty atom")
        if ch == "(":
            self.i += 1
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            name = self._alternation()
            if self.peek() != ")":
                raise self._err("unbalanced group")
            self.i += 1
            return (("r", name),)
        if ch == "[":
            return (("t", self._char_class()),)
        if ch == ".":
            self.i += 1
            return (("t", _ANY),)
        if ch in ")|*+?{":
            raise self._err(f"unexpected {ch!r}")
        if ch == "\\":
            self.i += 1
            esc = self.peek()
            if esc == "":
                raise self._err("dangling escape")
            self.i += 1
            cls = _CLASS_ESCAPES.get(esc)
            if cls is not None:
                return (("t", cls),)
            if esc in "^$":
                raise self._err("anchors are not supported (always full-match)")
            return lit(esc)
        self.i += 1
        return lit(ch)

    def _char_class(self) -> frozenset[int]:
        self.i += 1  # consume [
        negate = self.peek() == "^"
        if negate:
            self.i += 1
        out: set[int] = set()
        first = True
        while True:
            ch = self.peek()
            if ch == "":
                raise self._err("unterminated character class")
            if ch == "]" and not first:
                self.i += 1
                break
            first = False
            if ch == "\\":
                self.i += 1
                esc = self.peek()
                self.i += 1
                cls = _CLASS_ESCAPES.get(esc)
                if cls is not None:
                    out |= cls
                    continue
                lo_b = ord(esc)
            else:
                self.i += 1
                lo_b = ord(ch)
            if lo_b > 0xFF:
                raise self._err("non-Latin-1 character in class")
            if self.peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self.i += 1
                hi_c = self.peek()
                self.i += 1
                if hi_c == "\\":
                    hi_c = self.peek()
                    self.i += 1
                hi_b = ord(hi_c)
                if hi_b < lo_b or hi_b > 0xFF:
                    raise self._err("bad class range")
                out |= set(range(lo_b, hi_b + 1))
            else:
                out.add(lo_b)
        if negate:
            out = set(range(256)) - out
        if not out:
            raise self._err("empty character class")
        return frozenset(out)


def regex_to_grammar(pattern: str) -> tuple[dict[str, tuple[Alt, ...]], str]:
    """Compile the supported regex subset to (rules, start)."""
    if not isinstance(pattern, str) or not pattern:
        raise GrammarError("regex constraint needs a non-empty pattern string")
    rb = RuleBuilder("rx")
    start = _RegexParser(pattern, rb).parse()
    return rb.rules, start


def choices_to_grammar(choices) -> tuple[dict[str, tuple[Alt, ...]], str]:
    """Literal-alternatives constraint: exactly one of ``choices``."""
    if (
        not isinstance(choices, (list, tuple))
        or not choices
        or not all(isinstance(c, str) and c for c in choices)
    ):
        raise GrammarError("choice constraint needs a non-empty string list")
    rb = RuleBuilder("ch")
    start = rb.rule([lit(c) for c in choices])
    return rb.rules, start
