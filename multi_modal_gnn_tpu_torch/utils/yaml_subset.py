"""A reader and a writer for the YAML subset that ``conf/*.yaml`` use, with
the standard library only (the card's machine has no PyYAML).

The subset: one document of block mappings (indented by spaces), flow
mappings and flow lists written on one line (``{a: 1, b: [x, y]}``),
double- and single-quoted scalars, plain scalars, and ``#`` comments.  Plain
scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1): ``null`` /
``~`` / empty, the booleans (``true``, ``false``, ``yes``, ``no``, ``on``,
``off`` in their three spellings), decimal integers, and floats with a dot
(``0.00001``, ``1.0e-05``, ``.inf``, ``.nan``); ``1e-5`` is a string, as
there.  Everything else that ``safe_load`` would read differently or
specially (block sequences, anchors and aliases, tags, block scalars, merge
keys, multi-line flow collections or plain scalars, octal / hex / base-60
numbers, numbers with ``_``, timestamps, several documents, duplicate keys)
raises :class:`YAMLSubsetError` naming the line.

:func:`dump` writes nested dicts as block mappings and lists of scalars as
flow lists, every string double-quoted, so that both :func:`load` and
``yaml.safe_load`` read it back to the same value.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """The text lies outside the subset, or is not YAML."""


# yaml.safe_load's implicit resolvers (YAML 1.1, PyYAML resolver.py)
_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_YAML_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_YAML_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_SPECIAL_FLOATS = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}
# characters a plain scalar may not start with in this subset
_BAD_START = set("&*!|>%@`")
_FLOW_STOP = set(",[]{}")
_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _DECIMAL.match(text):
        return int(text)
    if _YAML_FLOAT.match(text) and "_" not in text and ":" not in text:
        low = text.lower()
        return _SPECIAL_FLOATS[low] if low in _SPECIAL_FLOATS else float(text)
    if (
        _YAML_INT.match(text) or _YAML_FLOAT.match(text) or _YAML_TIMESTAMP.match(text)
        or text in ("<<", "=")
    ):
        raise YAMLSubsetError(f"line {line}: {text!r} is outside the YAML subset")
    return text


class _Line:
    """One line's text from ``pos`` on, for the scanners below."""

    def __init__(self, text: str, number: int, pos: int):
        self.text, self.number, self.pos = text, number, pos

    def error(self, what: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"line {self.number}: {what}: {self.text.strip()!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces and an optional comment are left."""
        self.skip_spaces()
        return self.pos >= len(self.text) or self.peek() == "#"

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise self.error("unterminated or multi-line quoted scalar")
            ch = self.text[self.pos]
            if quote == "'" and ch == "'":
                if self.text[self.pos + 1 : self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == '"':
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == "\\":
                esc = self.text[self.pos + 1 : self.pos + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.pos += 2
                elif esc in _HEX_ESCAPES:
                    digits = self.text[self.pos + 2 : self.pos + 2 + _HEX_ESCAPES[esc]]
                    if len(digits) != _HEX_ESCAPES[esc] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error("bad escape")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + len(digits)
                else:
                    raise self.error("unknown escape or line continuation")
                continue
            out.append(ch)
            self.pos += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, ``: `` (or ``:`` at a flow
        indicator in flow context), a flow indicator in flow context, or the
        line's end; its value is resolved by the caller."""
        if self.peek() in _BAD_START or (self.peek() == "-" and self.text[self.pos + 1 : self.pos + 2] in ("", " ")):
            raise self.error("outside the YAML subset (anchor, alias, tag, block scalar or sequence)")
        start = self.pos
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            nxt = self.text[self.pos + 1 : self.pos + 2]
            if ch == "#" and self.pos > start and self.text[self.pos - 1] in " \t":
                break
            if ch == ":" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_STOP)):
                break
            if flow and ch in _FLOW_STOP:
                break
            self.pos += 1
        return self.text[start : self.pos].strip()

    def scalar(self, flow: bool) -> Tuple[Any, bool]:
        """``(value, was_quoted)``."""
        if self.peek() in ("'", '"'):
            return self.quoted(), True
        return _resolve(self.plain(flow), self.number), False

    def flow(self) -> Any:
        """A flow list or mapping that closes on this line."""
        opener = self.peek()
        closer = "]" if opener == "[" else "}"
        self.pos += 1
        items: Any = [] if opener == "[" else {}
        self.skip_spaces()
        if self.peek() == closer:
            self.pos += 1
            return items
        while True:
            self.skip_spaces()
            if not self.peek() or self.peek() == "#":
                raise self.error("multi-line flow collection")
            if opener == "[":
                items.append(self.flow_value())
            else:
                key, _ = self.scalar(flow=True)
                self.skip_spaces()
                if self.peek() != ":":
                    raise self.error("flow mapping entry without ': '")
                self.pos += 1
                self.skip_spaces()
                if self.peek() in (",", "}"):
                    value = None
                else:
                    value = self.flow_value()
                if not isinstance(key, str) or key in items:
                    raise self.error(f"non-string or duplicate key {key!r}")
                items[key] = value
            self.skip_spaces()
            if self.peek() == ",":
                self.pos += 1
                self.skip_spaces()
                if self.peek() == closer:
                    raise self.error("trailing comma in a flow collection")
                continue
            if self.peek() == closer:
                self.pos += 1
                return items
            raise self.error(f"expected ',' or {closer!r}")

    def flow_value(self) -> Any:
        if self.peek() in ("[", "{"):
            return self.flow()
        value, _ = self.scalar(flow=True)
        return value


def _significant_lines(text: str) -> List[Tuple[int, int, str]]:
    """``(number, indent, text)`` of each line that is not blank or a
    comment."""
    out = []
    for number, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t" or raw[: len(raw) - len(stripped)].count("\t"):
            raise YAMLSubsetError(f"line {number}: tab in indentation")
        if raw.startswith(("---", "...", "%")):
            raise YAMLSubsetError(f"line {number}: document markers and directives are outside the YAML subset")
        out.append((number, len(raw) - len(stripped), raw))
    return out


def _block_mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines):
        number, ind, raw = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSubsetError(f"line {number}: unexpected indentation")
        line = _Line(raw, number, ind)
        if line.peek() == "-" and raw[ind + 1 : ind + 2] in ("", " "):
            raise line.error("block sequences are outside the YAML subset")
        if line.peek() in ("[", "{", "?"):
            raise line.error("complex keys are outside the YAML subset")
        key, quoted = line.scalar(flow=False)
        line.skip_spaces()
        if line.peek() != ":":
            raise line.error("expected 'key: value'")
        line.pos += 1
        if not isinstance(key, str):
            raise line.error(f"non-string key {key!r}")
        if key in out:
            raise line.error(f"duplicate key {key!r}")
        i += 1
        if line.at_end():
            if i < len(lines) and lines[i][1] > indent:
                out[key], i = _block_mapping(lines, i, lines[i][1])
            else:
                out[key] = None
            continue
        out[key] = line.flow() if line.peek() in ("[", "{") else line.scalar(flow=False)[0]
        if not line.at_end():
            raise line.error("unexpected text after the value")
    return out, i


def load(text: str) -> Any:
    """The value of a YAML document in the subset: a dict, or None for an
    empty document."""
    lines = _significant_lines(text)
    if not lines:
        return None
    if lines[0][1] != 0:
        raise YAMLSubsetError(f"line {lines[0][0]}: the top-level mapping must start in column 0")
    out, i = _block_mapping(lines, 0, 0)
    if i != len(lines):
        raise YAMLSubsetError(f"line {lines[i][0]}: unexpected indentation")
    return out


def _scalar_text(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return f"{mantissa}e{exponent}" if exponent else mantissa
    if isinstance(value, str):
        return json.dumps(value)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _key_text(key: Any) -> str:
    if not isinstance(key, str):
        raise TypeError(f"mapping keys must be strings, got {key!r}")
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", key) and isinstance(_resolve(key, 0), str):
        return key
    return json.dumps(key)


def _flow_text(value: Any) -> str:
    if isinstance(value, dict):
        if value:
            raise TypeError("a mapping inside a list is outside the YAML subset's writer")
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow_text(v) for v in value) + "]"
    return _scalar_text(value)


def dump(data: dict, indent: int = 2) -> str:
    """``data`` (nested dicts of scalars and lists of scalars) as block
    YAML that :func:`load` and ``yaml.safe_load`` both read back equal."""

    def block(d: dict, depth: int) -> List[str]:
        lines = []
        pad = " " * (indent * depth)
        for key, value in d.items():
            if isinstance(value, dict) and value:
                lines.append(f"{pad}{_key_text(key)}:")
                lines.extend(block(value, depth + 1))
            else:
                lines.append(f"{pad}{_key_text(key)}: {_flow_text(value)}")
        return lines

    if not isinstance(data, dict):
        raise TypeError("the top level must be a mapping")
    return "\n".join(block(data, 0)) + "\n"


def load_file(path) -> Optional[Any]:
    with open(path) as f:
        return load(f.read())
