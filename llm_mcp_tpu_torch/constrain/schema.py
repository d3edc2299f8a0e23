"""Constraint specs → byte grammars (the port's copy of
`llm_mcp_tpu/constrain/schema.py`).

``build_grammar(spec)`` is the single entry point the compiler cache
keys on. A spec is a plain dict (what api/inference.py distills from
``response_format`` / ``tools``) with a ``type`` of:

- ``json_schema``: ``{"type": "json_schema", "schema": {...}}`` — the
  draft-ish subset agents actually send: ``type`` (object/array/string/
  number/integer/boolean/null), ``properties`` (+``required`` — we emit
  every listed property, in schema order, a documented simplification
  that keeps the automaton small and output canonical), ``items``,
  ``enum``/``const``, ``anyOf``/``oneOf``, and ``$ref`` into ``$defs``/
  ``definitions`` (recursive schemas become recursive rules, which the
  pushdown handles natively).
- ``json_object``: any syntactically valid JSON object (the OpenAI
  free-form JSON mode).
- ``regex``: ``{"type": "regex", "pattern": "..."}`` (subset, see
  grammar._RegexParser).
- ``choice``: ``{"type": "choice", "choices": ["a", "b"]}`` — exactly
  one literal.

The emitted JSON is COMPACT (no whitespace between tokens): every byte
the model may produce is one the grammar demands, so the mask never has
to reason about optional separators and the automaton stays minimal.

Unsupported constructs raise ``GrammarError`` → the API returns 400
rather than silently generating unconstrained output.

Pure stdlib: compilation runs on the API and
engine host threads before any device work exists.
"""

from __future__ import annotations

import json

from .grammar import (
    Alt,
    ByteAutomaton,
    GrammarError,
    RuleBuilder,
    choices_to_grammar,
    lit,
    regex_to_grammar,
)

# printable string payload bytes: anything >= 0x20 except '"' and '\'
# (multi-byte UTF-8 continuation bytes land here too — the automaton is
# byte-level, so non-ASCII text inside strings just works)
_STR_PLAIN = frozenset(
    b for b in range(0x20, 0x100) if b not in (0x22, 0x5C)
)
_HEX = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x47)) + list(range(0x61, 0x67))
)
_DIGIT = frozenset(range(0x30, 0x3A))
_DIGIT19 = frozenset(range(0x31, 0x3A))


def _json_string_rules(rb: RuleBuilder) -> str:
    """Shared rules for a JSON string literal ("..." with escapes)."""
    if "jstr" in rb.rules:
        return "jstr"
    esc_simple = ("t", frozenset(b'"\\/bfnrt'))
    uesc = (("t", frozenset((0x75,))),) + (("t", _HEX),) * 4  # uXXXX
    char = rb.add(
        "jstr_c",
        [
            (("t", _STR_PLAIN),),
            (("t", frozenset((0x5C,))), esc_simple),
            (("t", frozenset((0x5C,))),) + uesc,
        ],
    )
    chars = rb.add("jstr_cs", [(), (("r", char), ("r", "jstr_cs"))])
    return rb.add(
        "jstr",
        [(("t", frozenset((0x22,))), ("r", chars), ("t", frozenset((0x22,))))],
    )


def _json_number_rules(rb: RuleBuilder, integer: bool = False) -> str:
    name = "jint" if integer else "jnum"
    if name in rb.rules:
        return name
    digits1 = rb.rules.get("jdig1")
    if digits1 is None:
        digit = ("t", _DIGIT)
        rb.add("jdigs", [(), (digit, ("r", "jdigs"))])  # digit*
        rb.add("jdig1", [(digit, ("r", "jdigs"))])  # digit+
    int_part = rb.add(
        f"{name}_i",
        [
            (("t", frozenset((0x30,))),),  # 0
            (("t", _DIGIT19), ("r", "jdigs")),  # [1-9] digit*
        ],
    )
    minus = rb.rule([(), (("t", frozenset((0x2D,))),)])  # -?
    if integer:
        return rb.add(name, [(("r", minus), ("r", int_part))])
    frac = rb.rule(
        [(), (("t", frozenset((0x2E,))), ("r", "jdig1"))]
    )  # (. digit+)?
    sign = rb.rule([(), (("t", frozenset(b"+-")),)])
    exp = rb.rule(
        [(), (("t", frozenset(b"eE")), ("r", sign), ("r", "jdig1"))]
    )  # ([eE][+-]?digit+)?
    return rb.add(
        name,
        [(("r", minus), ("r", int_part), ("r", frac), ("r", exp))],
    )


def _generic_json_rules(rb: RuleBuilder) -> str:
    """Any JSON value — used by json_object mode and additionalProperties-
    free fallbacks. Mutually recursive rules; the pushdown nests freely."""
    if "jval" in rb.rules:
        return "jval"
    jstr = _json_string_rules(rb)
    jnum = _json_number_rules(rb)
    rb.add(
        "jval",
        [
            (("r", jstr),),
            (("r", jnum),),
            lit("true"),
            lit("false"),
            lit("null"),
            (("r", "jobj"),),
            (("r", "jarr"),),
        ],
    )
    member = rb.add(
        "jmem", [(("r", jstr), ("t", frozenset((0x3A,))), ("r", "jval"))]
    )
    mem_tail = rb.add(
        "jmem_t",
        [(), (("t", frozenset((0x2C,))), ("r", member), ("r", "jmem_t"))],
    )
    rb.add(
        "jobj",
        [
            lit("{}"),
            (
                ("t", frozenset((0x7B,))),
                ("r", member),
                ("r", "jmem_t"),
                ("t", frozenset((0x7D,))),
            ),
        ],
    )
    val_tail = rb.add(
        "jval_t",
        [(), (("t", frozenset((0x2C,))), ("r", "jval"), ("r", "jval_t"))],
    )
    rb.add(
        "jarr",
        [
            lit("[]"),
            (
                ("t", frozenset((0x5B,))),
                ("r", "jval"),
                ("r", val_tail),
                ("t", frozenset((0x5D,))),
            ),
        ],
    )
    return "jval"


class _SchemaCompiler:
    MAX_DEPTH = 64

    def __init__(self, root: dict):
        self.rb = RuleBuilder("js")
        self.root = root
        self._refs: dict[str, str] = {}  # $ref path -> rule name

    def compile(self) -> tuple[dict, str]:
        start = self._node(self.root, 0)
        return self.rb.rules, start

    def _resolve_ref(self, ref: str) -> dict:
        if ref == "#":
            return self.root
        if not isinstance(ref, str) or not ref.startswith("#/"):
            raise GrammarError(f"unsupported $ref {ref!r} (only '#/...' paths)")
        node = self.root
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise GrammarError(f"$ref {ref!r} does not resolve")
            node = node[part]
        if not isinstance(node, dict):
            raise GrammarError(f"$ref {ref!r} target is not a schema object")
        return node

    def _node(self, sch, depth: int) -> str:
        if depth > self.MAX_DEPTH:
            raise GrammarError("schema nesting exceeds supported depth")
        if sch is True or sch == {}:
            return _generic_json_rules(self.rb)
        if not isinstance(sch, dict):
            raise GrammarError("schema node must be an object")
        if "$ref" in sch:
            ref = sch["$ref"]
            name = self._refs.get(ref)
            if name is None:
                # pre-register before building so recursion terminates
                name = self.rb.fresh()
                self._refs[ref] = name
                target = self._resolve_ref(ref)
                inner = self._node(target, depth + 1)
                self.rb.add(name, [(("r", inner),)])
            return name
        if "const" in sch:
            return self.rb.rule([lit(json.dumps(sch["const"], separators=(",", ":")))])
        if "enum" in sch:
            vals = sch["enum"]
            if not isinstance(vals, list) or not vals:
                raise GrammarError("enum must be a non-empty list")
            return self.rb.rule(
                [lit(json.dumps(v, separators=(",", ":"))) for v in vals]
            )
        for key in ("anyOf", "oneOf"):
            if key in sch:
                subs = sch[key]
                if not isinstance(subs, list) or not subs:
                    raise GrammarError(f"{key} must be a non-empty list")
                names = [self._node(s, depth + 1) for s in subs]
                return self.rb.rule([(("r", n),) for n in names])
        typ = sch.get("type")
        if isinstance(typ, list):
            names = [self._node({**sch, "type": t_}, depth + 1) for t_ in typ]
            return self.rb.rule([(("r", n),) for n in names])
        if typ == "object" or (typ is None and "properties" in sch):
            return self._object(sch, depth)
        if typ == "array":
            return self._array(sch, depth)
        if typ == "string":
            return _json_string_rules(self.rb)
        if typ == "number":
            return _json_number_rules(self.rb)
        if typ == "integer":
            return _json_number_rules(self.rb, integer=True)
        if typ == "boolean":
            return self.rb.rule([lit("true"), lit("false")])
        if typ == "null":
            return self.rb.rule([lit("null")])
        if typ is None:
            return _generic_json_rules(self.rb)
        raise GrammarError(f"unsupported schema type {typ!r}")

    def _object(self, sch: dict, depth: int) -> str:
        props = sch.get("properties")
        if props is None:
            return self._generic_object()
        if not isinstance(props, dict):
            raise GrammarError("properties must be an object")
        if not props:
            return self.rb.rule([lit("{}")])
        # every listed property is emitted, in schema order — documented
        # simplification: canonical output, O(props) automaton size
        seq: list = [("t", frozenset((0x7B,)))]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                seq.append(("t", frozenset((0x2C,))))
            seq.extend(lit(json.dumps(key, separators=(",", ":")) + ":"))
            seq.append(("r", self._node(sub, depth + 1)))
        seq.append(("t", frozenset((0x7D,))))
        return self.rb.rule([tuple(seq)])

    def _generic_object(self) -> str:
        _generic_json_rules(self.rb)
        return "jobj"

    def _array(self, sch: dict, depth: int) -> str:
        items = sch.get("items")
        inner = (
            self._node(items, depth + 1)
            if items is not None
            else _generic_json_rules(self.rb)
        )
        tail = self.rb.fresh()
        self.rb.rules[tail] = (
            (),
            (("t", frozenset((0x2C,))), ("r", inner), ("r", tail)),
        )
        min_items = sch.get("minItems", 0)
        alts: list[Alt] = []
        if min_items in (0, None):
            alts.append(lit("[]"))
        alts.append(
            (
                ("t", frozenset((0x5B,))),
                ("r", inner),
                ("r", tail),
                ("t", frozenset((0x5D,))),
            )
        )
        return self.rb.rule(alts)


def schema_to_grammar(schema) -> tuple[dict, str]:
    if not isinstance(schema, (dict, bool)):
        raise GrammarError("json_schema constraint needs a schema object")
    return _SchemaCompiler(schema if isinstance(schema, dict) else {}).compile()


def build_grammar(spec: dict) -> tuple[dict, str]:
    """Spec dict → (rules, start). Raises GrammarError on bad specs."""
    if not isinstance(spec, dict):
        raise GrammarError("constraint spec must be an object")
    typ = spec.get("type")
    if typ == "json_schema":
        return schema_to_grammar(spec.get("schema"))
    if typ == "json_object":
        rb = RuleBuilder("jo")
        _generic_json_rules(rb)
        return rb.rules, "jobj"
    if typ == "regex":
        return regex_to_grammar(spec.get("pattern"))
    if typ == "choice":
        return choices_to_grammar(spec.get("choices"))
    raise GrammarError(f"unsupported constraint type {typ!r}")


def build_automaton(spec: dict) -> ByteAutomaton:
    rules, start = build_grammar(spec)
    return ByteAutomaton(rules, start)
