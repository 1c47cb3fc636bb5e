"""JSON-Schema-guided decoding: structured outputs on top of the logit-mask
machinery (jsonmode.py).

A copy of ``aios_tpu/engine/jsonschema.py``: ``compile_schema`` (the same
``ValueError`` for each rejected schema), ``SchemaMachine``,
``SchemaMaskCache`` (which also takes ``device``) and ``schema_cache_key``.

Where jsonmode's generic automaton guarantees *some* JSON object, this
module compiles a schema (a practical subset of JSON Schema) into a byte
automaton that guarantees the model's output matches an exact SHAPE —
known/required object keys (steered byte-by-byte through a property-name
prefix trie), string enums (e.g. the orchestrator's tool-name set), integer
vs number, booleans/null, arrays, nested schemas, and free-form `{}`
subtrees for open fields like tool-call args. This is the engine's
equivalent of "structured outputs" in modern serving stacks; the reference
has nothing comparable (its autonomy loop re-prompts through JSON-repair
rounds when the model's tool_calls don't parse, autonomy.rs:290-328 —
guided decoding makes the first round parse by construction).

Supported schema subset (validated at compile time):
  {"type": "object", "properties": {...}, "required": [...]}
  {"type": "array", "items": <schema>}   (optionally "minItems": 0|1)
  {"type": "string"}  /  {"type": "string", "enum": [...]}
  {"type": "number"} / {"type": "integer"} / {"type": "boolean"}
  {"type": "null"}   /  {} or {"type": "any"} — any JSON value
  {"const": <string>} — sugar for a one-element enum

Unknown object keys are impossible by construction (every key byte is
steered through the trie), required keys gate '}', and the closing mask
(budget exhaustion) drives the shortest completion that still satisfies
the schema. States are small tuples over a frame stack; the shared
vectorized mask cache (SchemaMaskCache) does the per-state vocab walks.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from . import jsonmode
from .jsonmode import _NUM_DONE, JsonMaskCache

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")

# node kinds
OBJ, ARR, STR, ENUM, NUM, INT, BOOL, NULL, ANY, ANYOBJ = range(10)


class Schema:
    """Compiled schema: a flat node table the automaton indexes into."""

    def __init__(self) -> None:
        self.kinds: List[int] = []
        # OBJ: (props {name_bytes: node_id}, required frozenset[name_bytes])
        # ARR: (items_id, min_items)
        # ENUM: tuple of value bytes
        self.data: List[object] = []

    def add(self, kind: int, data=None) -> int:
        self.kinds.append(kind)
        self.data.append(data)
        return len(self.kinds) - 1


def _check_enum_value(v) -> bytes:
    """Enum/const values are matched (and emitted) as raw bytes inside the
    string — values needing JSON escapes could never be produced (or would
    decode differently), so reject them at compile time."""
    if not isinstance(v, str) or not v:
        raise ValueError(f"enum values must be non-empty strings: {v!r}")
    if '"' in v or "\\" in v or any(ord(c) < 0x20 for c in v):
        raise ValueError(
            f"enum value {v!r} contains characters that need JSON string "
            "escapes (unsupported)"
        )
    return v.encode("utf-8")


def compile_schema(schema: dict) -> Tuple[Schema, int]:
    """Compile a schema dict; returns (table, root node id). Raises
    ValueError on anything outside the supported subset (client input —
    the service maps it to INVALID_ARGUMENT)."""
    table = Schema()

    def build(node) -> int:
        if not isinstance(node, dict):
            raise ValueError(f"schema node must be an object: {node!r}")
        if "const" in node:
            return table.add(ENUM, (_check_enum_value(node["const"]),))
        t = node.get("type")
        if t is None or t == "any":
            return table.add(ANY)
        if t == "object":
            props = node.get("properties", {})
            if not isinstance(props, dict) or not all(
                isinstance(k, str) for k in props
            ):
                raise ValueError("properties must be an object")
            required = node.get("required", list(props.keys()))
            if not isinstance(required, (list, tuple)) or not all(
                isinstance(k, str) for k in required
            ):
                raise ValueError("required must be a list of strings")
            unknown = set(required) - set(props)
            if unknown:
                raise ValueError(f"required keys not in properties: {unknown}")
            for k in props:
                _check_enum_value(k)  # same byte-emission constraints
            if not props:
                # open object: any keys/values, but still an OBJECT
                return table.add(ANYOBJ)
            nid = table.add(OBJ, None)  # reserve (cycles not supported)
            compiled = {
                k.encode("utf-8"): build(v) for k, v in props.items()
            }
            table.data[nid] = (
                compiled,
                frozenset(k.encode("utf-8") for k in required),
            )
            return nid
        if t == "array":
            items = node.get("items", {})
            min_items = node.get("minItems", 0)
            if min_items not in (0, 1):
                raise ValueError("minItems supports 0 or 1")
            nid = table.add(ARR, None)
            table.data[nid] = (build(items), int(min_items))
            return nid
        if t == "string":
            enum = node.get("enum")
            if enum is not None:
                if not isinstance(enum, (list, tuple)) or not enum:
                    raise ValueError("enum must be a non-empty list")
                vals = tuple(sorted(_check_enum_value(v) for v in enum))
                return table.add(ENUM, vals)
            return table.add(STR)
        if t == "integer":
            return table.add(INT)
        if t == "number":
            return table.add(NUM)
        if t == "boolean":
            return table.add(BOOL)
        if t == "null":
            return table.add(NULL)
        raise ValueError(f"unsupported schema type: {t!r}")

    try:
        return table, build(schema)
    except ValueError:
        raise
    except Exception as e:  # malformed client input must not escape as
        raise ValueError(f"malformed schema: {e}") from e  # internal errors


# ---------------------------------------------------------------------------
# the automaton
#
# state tuples (stack is a tuple of frames):
#   ("V", stack, nid)          expecting a value of node nid (ws ok)
#   ("E", stack)               value complete; continuation from top frame
#   ("KQ", stack)              object: expecting '"' (key) or maybe '}'
#   ("KQ1", stack)             object after ',': expecting '"' only
#   ("K", stack, prefix)       inside a key string; prefix bytes matched
#   ("C", stack, key)          after key close: expecting ':' (ws ok)
#   ("S", stack) ("X", stack) ("U", stack, n)    free string / escapes
#   ("SE", stack, nid, prefix) inside an enum string
#   ("N", stack, sub, is_int)  number; sub as in jsonmode
#   ("L", stack, lit, pos)     literal true/false/null
#   ("Y", stack, inner)        free-form subtree; inner = jsonmode state
# frames:
#   ("o", nid, seen frozenset[bytes])
#   ("a", nid, emitted 0|1)    emitted saturates at 1 (minItems gate)
# ---------------------------------------------------------------------------

SState = Tuple


class SchemaMachine:
    def __init__(self, table: Schema, root: int, max_depth: int = 16,
                 compact: bool = False) -> None:
        self.t = table
        self.root = root
        self.max_depth = max_depth
        # compact: disallow inter-element whitespace (string/enum/key
        # CONTENT keeps its spaces) so schema-forced positions become
        # singleton states — the property jump-ahead decoding compresses
        # into multi-token runs (see jsonmode.next_state's compact doc)
        self.compact = compact

    def start(self) -> SState:
        return ("V", (), self.root)

    def terminal(self, st: SState) -> bool:
        return st[0] == "E" and st[1] == ()

    # -- transitions --------------------------------------------------------

    def step(self, st: SState, b: int) -> Optional[SState]:
        phase, stack = st[0], st[1]
        t = self.t

        if phase == "E":
            if b in _WS:
                return None if self.compact else st
            if not stack:
                return None
            top = stack[-1]
            if top[0] == "o":
                _, nid, seen = top
                props, required = t.data[nid]
                if b == ord(","):
                    if set(props) - seen:  # some key still addable
                        return ("KQ1", stack)
                    return None
                if b == ord("}") and required <= seen:
                    return ("E", stack[:-1])
                return None
            # array frame
            _, nid, _emitted = top
            items, _min = t.data[nid]
            if b == ord(","):
                return ("V", stack, items)
            if b == ord("]"):
                return ("E", stack[:-1])
            return None

        if phase == "V":
            nid = st[2]
            if b in _WS:
                return None if self.compact else st
            kind = t.kinds[nid]
            if kind == ANY:
                inner = jsonmode.next_state(("V", ""), b, self.max_depth,
                                            self.compact)
                if inner is None:
                    return None
                return self._norm_y(stack, inner, b)
            if kind == ANYOBJ:  # free-form keys/values, but an OBJECT
                if b != ord("{"):
                    return None
                inner = jsonmode.next_state(("V", ""), b, self.max_depth,
                                            self.compact)
                return self._norm_y(stack, inner, b)
            if kind == OBJ:
                if b == ord("{") and len(stack) < self.max_depth:
                    return ("KQ", stack + (("o", nid, frozenset()),))
                return None
            if kind == ARR:
                if b == ord("[") and len(stack) < self.max_depth:
                    items, min_items = t.data[nid]
                    frame = ("a", nid, 0)
                    # empty array closes immediately unless minItems
                    return ("AV", stack + (frame,), items, min_items)
                return None
            if kind == STR:
                return ("S", stack) if b == ord('"') else None
            if kind == ENUM:
                return ("SE", stack, nid, b"") if b == ord('"') else None
            if kind in (NUM, INT):
                is_int = kind == INT
                if b == ord("-"):
                    return ("N", stack, "-", is_int)
                if b == ord("0"):
                    return ("N", stack, "0", is_int)
                if b in _DIGITS:
                    return ("N", stack, "i", is_int)
                return None
            if kind == BOOL:
                if b == ord("t"):
                    return ("L", stack, "true", 1)
                if b == ord("f"):
                    return ("L", stack, "false", 1)
                return None
            if kind == NULL:
                return ("L", stack, "null", 1) if b == ord("n") else None
            return None

        if phase == "AV":  # first array slot: value or (if allowed) ']'
            nid_items, min_items = st[2], st[3]
            if b in _WS:
                return None if self.compact else st
            if b == ord("]") and min_items == 0:
                return ("E", stack[:-1])
            return self.step(("V", stack, nid_items), b)

        if phase in ("KQ", "KQ1"):
            if b in _WS:
                return None if self.compact else st
            top = stack[-1]
            _, nid, seen = top
            props, required = t.data[nid]
            if b == ord('"'):
                return ("K", stack, b"")
            if phase == "KQ" and b == ord("}") and required <= seen:
                return ("E", stack[:-1])
            return None

        if phase == "K":  # key prefix trie over unseen property names
            prefix = st[2]
            top = stack[-1]
            _, nid, seen = top
            props, _required = t.data[nid]
            if b == ord('"'):
                if prefix in props and prefix not in seen:
                    return ("C", stack, prefix)
                return None
            cand = prefix + bytes([b])
            for name in props:
                if name not in seen and name.startswith(cand):
                    return ("K", stack, cand)
            return None

        if phase == "C":
            key = st[2]
            if b in _WS:
                return None if self.compact else st
            if b == ord(":"):
                top = stack[-1]
                _, nid, seen = top
                props, _req = t.data[nid]
                new_top = ("o", nid, seen | {key})
                return ("V", stack[:-1] + (new_top,), props[key])
            return None

        if phase == "S":
            if b == ord('"'):
                return ("E", stack)
            if b == ord("\\"):
                return ("X", stack)
            return st if b >= 0x20 else None

        if phase == "X":
            if b in b'"\\/bfnrt':
                return ("S", stack)
            if b == ord("u"):
                return ("U", stack, 0)
            return None

        if phase == "U":
            n = st[2]
            if b in _HEX:
                return ("S", stack) if n == 3 else ("U", stack, n + 1)
            return None

        if phase == "SE":
            nid, prefix = st[2], st[3]
            vals = self.t.data[nid]
            if b == ord('"'):
                return ("E", stack) if prefix in vals else None
            cand = prefix + bytes([b])
            for v in vals:
                if v.startswith(cand):
                    return ("SE", stack, nid, cand)
            return None

        if phase == "L":
            lit, pos = st[2], st[3]
            if b == ord(lit[pos]):
                if pos + 1 == len(lit):
                    return ("E", stack)
                return ("L", stack, lit, pos + 1)
            return None

        if phase == "N":
            sub, is_int = st[2], st[3]
            if sub == "-":
                if b == ord("0"):
                    return ("N", stack, "0", is_int)
                if b in _DIGITS:
                    return ("N", stack, "i", is_int)
                return None
            if sub in ("0", "i"):
                if sub == "i" and b in _DIGITS:
                    return st
                if not is_int:
                    if b == ord("."):
                        return ("N", stack, ".", is_int)
                    if b in (ord("e"), ord("E")):
                        return ("N", stack, "e", is_int)
            if sub == ".":
                return ("N", stack, "f", is_int) if b in _DIGITS else None
            if sub == "f":
                if b in _DIGITS:
                    return st
                if b in (ord("e"), ord("E")):
                    return ("N", stack, "e", is_int)
            if sub == "e":
                if b in (ord("+"), ord("-")):
                    return ("N", stack, "s", is_int)
                if b in _DIGITS:
                    return ("N", stack, "E", is_int)
                return None
            if sub == "s":
                return ("N", stack, "E", is_int) if b in _DIGITS else None
            if sub == "E" and b in _DIGITS:
                return st
            if sub in _NUM_DONE:  # complete number: delegate terminator
                return self.step(("E", stack), b)
            return None

        if phase == "Y":  # free-form subtree via the generic machine
            inner = st[2]
            nxt = jsonmode.next_state(inner, b, self.max_depth, self.compact)
            if nxt is None:
                # the generic machine can't see the schema continuation: a
                # COMPLETE inner value followed by ',', '}', ']' must pop
                # back to the schema frame
                if jsonmode.is_terminal(inner) or (
                    inner[0] == "N" and inner[2] in _NUM_DONE
                    and inner[1] == ""
                ):
                    return self.step(("E", stack), b)
                return None
            return self._norm_y(stack, nxt, b)

        return None

    def _norm_y(self, stack, inner, b) -> SState:
        """Wrap a generic-machine state; a completed top-level inner value
        collapses back to the schema's E."""
        if jsonmode.is_terminal(inner):
            return ("E", stack)
        return ("Y", stack, inner)

    # -- closing distance --------------------------------------------------
    #
    # Minimal completion cost in BYTES — an upper bound on the TOKENS a
    # closing walk needs (a token carries >= 1 byte), so the budget-aware
    # switch engages early enough on every tokenizer. Mid-key states must
    # count the whole remaining key + quote + colon + a minimal value —
    # the generic per-phase constants of jsonmode underestimate that
    # badly (observed: truncation inside a schema key at budget end).

    def _node_cost(self, nid: int) -> int:
        cached = getattr(self, "_node_costs", None)
        if cached is None:
            cached = self._node_costs = {}
        got = cached.get(nid)
        if got is not None:
            return got
        cached[nid] = 2 + self.max_depth * 8  # cycle guard (unused: no refs)
        t = self.t
        kind = t.kinds[nid]
        if kind in (NUM, INT):
            c = 1  # "0"
        elif kind == BOOL:
            c = 4  # true
        elif kind == NULL:
            c = 4
        elif kind == STR:
            c = 2  # ""
        elif kind == ENUM:
            c = 2 + min(len(v) for v in t.data[nid])
        elif kind in (ANY, ANYOBJ):
            c = 2  # {}
        elif kind == ARR:
            items, min_items = t.data[nid]
            c = 2 + (self._node_cost(items) if min_items else 0)
        else:  # OBJ
            props, required = t.data[nid]
            c = 2
            for k in required:
                # "key":<value> plus a comma between entries
                c += len(k) + 4 + self._node_cost(props[k])
            if required:
                c -= 1  # no trailing comma
        cached[nid] = c
        return c

    def _entry_cost(self, name: bytes, props, prefix_done: int = 0) -> int:
        """Remaining bytes for the TAIL of `name":<minimal value>` given
        ``prefix_done`` name bytes emitted (close quote + colon included,
        OPEN quote not)."""
        return (
            len(name) - prefix_done + 2 + self._node_cost(props[name])
        )

    def _frame_charge(self, name: bytes, props) -> int:
        """Bytes one missing required entry adds: `,"` + the entry tail."""
        return 2 + self._entry_cost(name, props)

    def distance(self, st: SState) -> int:
        """Bytes of the cheapest completion from ``st``. Along a closing
        walk every consumed byte reduces this by >= 1 (signed phase
        extras UNCHARGE the enclosing frame's estimate for the required
        entry currently being typed), so min-distance token selection
        can never dither in place."""
        phase, stack = st[0], st[1]
        t = self.t
        d = 0
        for fr in stack:
            if fr[0] == "o":
                _, nid, seen = fr
                props, required = t.data[nid]
                d += 1  # '}'
                for k in required - seen:
                    d += self._frame_charge(k, props)
            else:
                d += 1  # ']'
        if phase == "E":
            return d
        if phase == "N":
            return d if st[2] in _NUM_DONE else d + 1
        if phase == "S":
            return d + 1  # closing quote
        if phase == "X":
            return d + 2  # escape char + quote
        if phase == "U":
            return d + (4 - st[2]) + 1
        if phase == "SE":
            _, _, nid, prefix = st
            vals = [v for v in t.data[nid] if v.startswith(prefix)]
            return d + min(len(v) - len(prefix) for v in vals) + 1
        if phase == "L":
            return d + len(st[2]) - st[3]
        if phase in ("KQ", "KQ1", "K", "C"):
            top = stack[-1]
            _, nid, seen = top
            props, required = t.data[nid]
            if phase == "C":
                key = st[2]
                extra = 1 + self._node_cost(props[key])  # ':' + value
                if key in required:
                    extra -= self._frame_charge(key, props)
                return d + extra
            if phase == "K":
                prefix = st[2]
                best = None
                for name in props:
                    if name in seen or not name.startswith(prefix):
                        continue
                    cost = self._entry_cost(name, props, len(prefix))
                    if name in required:
                        cost -= self._frame_charge(name, props)
                    best = cost if best is None else min(best, cost)
                return d + (best if best is not None else 1)
            if phase == "KQ1":  # comma emitted: a key must follow
                best = None
                for name in props:
                    if name in seen:
                        continue
                    cost = 1 + self._entry_cost(name, props)  # open quote
                    if name in required:
                        cost -= self._frame_charge(name, props)
                    best = cost if best is None else min(best, cost)
                return d + (best if best is not None else 1)
            # KQ: '}' or the (already charged) required entries; the first
            # entry after '{' needs no comma, so uncharge one byte —
            # without this '{' never reduces the distance and the
            # feasibility gate can dither on whitespace at the budget edge
            return d - (1 if required - seen else 0)
        if phase == "Y":
            # generic distances are exact byte minimums now
            return d + jsonmode.distance_to_terminal(st[2])
        if phase == "AV":
            return d + (self._node_cost(st[2]) if st[3] else 0)
        if phase == "V":
            return d + self._node_cost(st[2])
        return d + 1


class SchemaMaskCache(JsonMaskCache):
    """Mask cache over a compiled schema automaton (one per (model,
    schema); see ContinuousBatcher's registry)."""

    def __init__(
        self,
        token_bytes,
        eos_id,
        schema: dict,
        max_depth: int = 16,
        byte_matrix=None,
        compact: bool = False,
        device=None,
    ) -> None:
        table, root = compile_schema(schema)
        self.machine = SchemaMachine(table, root, max_depth, compact=compact)
        super().__init__(
            token_bytes,
            eos_id,
            require_object=True,
            max_depth=max_depth,
            byte_matrix=byte_matrix,
            compact=compact,
            device=device,
        )
        # the forced opener depends on the root node kind
        root_kind = table.kinds[root]
        opener = {OBJ: b"{", ARR: b"[", ANY: b"{", ANYOBJ: b"{"}.get(
            root_kind
        )
        if opener is None:
            self.start_token_id = None  # scalar roots: no forced opener
        else:
            self.start_token_id = None
            for i, tb in enumerate(token_bytes):
                if tb == opener:
                    self.start_token_id = i
                    break

    def start(self):
        return self.machine.start()

    def _transition(self, state, b):
        return self.machine.step(state, b)

    def _terminal(self, state) -> bool:
        return self.machine.terminal(state)

    def _distance(self, state) -> int:
        return self.machine.distance(state)


def schema_cache_key(schema: dict) -> str:
    """Canonical registry key for a schema dict."""
    return json.dumps(schema, sort_keys=True, separators=(",", ":"))
