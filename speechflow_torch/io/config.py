"""YAML configs without PyYAML (counterpart of ``speechflow_tpu/io/config.py``).

The machine with the GPU has no PyYAML, so the port reads the subset of YAML
that ``configs/*.yml`` and the JAX loader use, with the result PyYAML's
``SafeLoader`` (YAML 1.1) gives:

- block mappings and sequences (a sequence may sit at its key's indent, and
  an item may open a mapping: ``- name: x``), flow ``{...}`` and ``[...]``
  (over several lines too), comments;
- plain, single-quoted and double-quoted scalars; a plain scalar resolves as
  PyYAML's implicit resolvers do: ``yes``/``no``/``on``/``off``/``true``/
  ``false`` in their three casings are bools, ``~``/``null``/empty is None,
  ints in decimal, ``0b``, ``0x``, octal ``0…`` and ``a:b`` base 60, floats
  only with a dot (``1e-4`` stays a string, ``1.0e-4`` needs its sign) or
  ``.inf``/``.nan``, dates and timestamps; ``_`` separators are dropped;
- the ``!join`` tag: ``os.path.join`` of a sequence's items, as the JAX
  loader registers it.

Anything else (anchors and aliases, merge keys, several documents, block
scalars ``|`` / ``>``, other tags, complex keys, multi-line plain or quoted
scalars, tabs in indentation) raises ``ConfigError`` with its line number.

On top: ``value_select`` (a mapping that holds a ``default`` key collapses to
the value of the first selector it holds, else its ``default``), ``Config``
(a file read with one ``value_select`` applied), and ``yaml_dump``, which
writes a config as block YAML that PyYAML and this reader read back to the
same values.
"""

from __future__ import annotations

import copy
import datetime
import hashlib
import json
import math
import os
import re
import typing as tp
from pathlib import Path

__all__ = ["Config", "ConfigError", "yaml_load", "yaml_dump", "value_select",
           "change_config_file"]


class ConfigError(ValueError):
    """A YAML text outside the subset the reader supports, or malformed."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


# --------------------------------------------------------------------------- #
#  scalars (PyYAML's implicit resolvers and constructors, YAML 1.1)           #
# --------------------------------------------------------------------------- #

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)

# (first characters, pattern, constructor name), in PyYAML's registration order
_RESOLVERS = [("yYnNtTfFoO", _BOOL, "bool"), ("-+0123456789.", _FLOAT, "float"),
              ("-+0123456789", _INT, "int"), ("<", re.compile(r"^(?:<<)$"), "merge"),
              ("~nN", _NULL, "null"), ("0123456789", _TIMESTAMP, "timestamp"),
              ("=", re.compile(r"^(?:=)$"), "value")]


def _base60(value: str, cast) -> tp.Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _base60(value, float)
    return sign * float(value)


def _to_timestamp(value: str) -> tp.Union[datetime.date, datetime.datetime]:
    v = _TIMESTAMP_PARTS.match(value).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0")) if v["fraction"] else 0
    tz = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tz = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tz)


def resolve_plain(value: str, line: int = 0) -> tp.Any:
    """A plain scalar's value, as PyYAML's ``SafeLoader`` constructs it."""
    first = value[:1]
    for chars, pattern, kind in _RESOLVERS:
        if (first in chars if first else kind == "null") and pattern.match(value):
            if kind == "bool":
                return value.lower() in ("yes", "true", "on")
            if kind == "float":
                return _to_float(value)
            if kind == "int":
                return _to_int(value)
            if kind == "null":
                return None
            if kind == "timestamp":
                return _to_timestamp(value)
            raise ConfigError(line, f"{value!r}: YAML {kind} keys are not supported")
    return value


# --------------------------------------------------------------------------- #
#  the reader                                                                 #
# --------------------------------------------------------------------------- #

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",]}"


class _Line(tp.NamedTuple):
    no: int       # 1-based line number
    indent: int   # column of the content
    text: str     # content, comment stripped, trailing space removed


def _strip_comment(raw: str, no: int) -> str:
    """``raw`` without its comment (a ``#`` at the start or after whitespace,
    outside quotes)."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i]
        i += 1
    if quote:
        raise ConfigError(no, "a quoted scalar over several lines is not supported")
    return raw


# PyYAML's Reader refuses every character outside this set
_NON_PRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd"
                            "\U00010000-\U0010ffff]")


def _split_lines(text: str) -> tp.List[str]:
    """The lines as PyYAML breaks them: at ``\r\n``, ``\r``, ``\n`` and
    ``\x85`` everywhere (a quoted scalar they cut is one over several lines),
    and at U+2028 and U+2029 except inside a quoted scalar, whose content they
    are (``str.splitlines`` also breaks at those two inside quotes, and at
    ``\x0b``, ``\x0c`` and ``\x1c``-``\x1e``, which PyYAML refuses)."""
    out: tp.List[str] = []
    start = 0
    quote = None
    comment = False
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c in "\r\n\x85" or (c in "\u2028\u2029" and not quote):
            out.append(text[start:i])
            i += 2 if text[i:i + 2] == "\r\n" else 1
            start, quote, comment = i, None, False
            continue
        if comment:
            pass
        elif quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == start or text[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == start or text[i - 1] in " \t"):
            comment = True
        i += 1
    if start < n:
        out.append(text[start:])
    return out


def _lines(text: str) -> tp.List[_Line]:
    out: tp.List[_Line] = []
    for no, raw in enumerate(_split_lines(text), 1):
        bad = _NON_PRINTABLE.search(raw)
        if bad:
            raise ConfigError(no, f"the non-printable character {bad.group(0)!r}")
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise ConfigError(no, "a tab in the indentation")
        content = _strip_comment(body, no).rstrip()
        if not content:
            continue
        if content.startswith("%"):
            raise ConfigError(no, "YAML directives are not supported")
        if content in ("---", "...") or content.startswith(("--- ", "... ")):
            if out or content != "---":
                raise ConfigError(no, "several documents (or '...') are not supported")
            continue
        out.append(_Line(no, len(raw) - len(body), content))
    return out


class _Flow:
    """A parser over one flow or inline value (one line, or lines joined)."""

    def __init__(self, text: str, no: int):
        self.s, self.i, self.no = text, 0, no

    def error(self, message: str) -> ConfigError:
        return ConfigError(self.no, message)

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def node(self, flow: bool) -> tp.Any:
        """One node at the cursor: tagged, flow collection, quoted or plain."""
        self.ws()
        c = self.peek()
        if c == "!":
            m = re.match(r"!\S*", self.s[self.i:])
            tag = m.group(0)
            if tag != "!join":
                raise self.error(f"the tag {tag!r} is not supported (only !join)")
            self.i += len(tag)
            self.ws()
            if self.peek() != "[":
                raise self.error("!join takes a flow sequence [...]")
            parts = self.node(flow)
            return os.path.join(*[str(p) for p in parts])
        if c in "&*":
            raise self.error("anchors and aliases are not supported")
        if c in "|>":
            raise self.error("block scalars (| and >) are not supported")
        if c == "?":
            raise self.error("complex mapping keys are not supported")
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c == "'":
            return self.single()
        if c == '"':
            return self.double()
        if c in "@`":
            raise self.error(f"a plain scalar cannot start with {c!r}")
        return resolve_plain(self.plain(flow), self.no)

    def plain(self, flow: bool, key: bool = False) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_END)):
                break
            if flow and c in _FLOW_END + "[{":
                break
            self.i += 1
        return self.s[start:self.i].rstrip()

    def single(self) -> str:
        out = []
        self.i += 1
        while True:
            j = self.s.find("'", self.i)
            if j < 0:
                raise self.error("unterminated single-quoted scalar")
            out.append(self.s[self.i:j])
            if self.s[j + 1:j + 2] == "'":
                out.append("'")
                self.i = j + 2
                continue
            self.i = j + 1
            return "".join(out)

    def double(self) -> str:
        out = []
        self.i += 1
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.i += 1
        raise self.error("unterminated double-quoted scalar")

    def key(self, flow: bool) -> tp.Any:
        self.ws()
        c = self.peek()
        if c == "'":
            return self.single()
        if c == '"':
            return self.double()
        if c in "[{":
            raise self.error("complex mapping keys are not supported")
        if c in "!&*?|>":
            return self.node(flow)  # raises for everything but a tag
        return resolve_plain(self.plain(flow, key=True), self.no)

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.peek() == "]":
                self.i += 1
                return out
            start = self.i
            item = self.node(flow=True)
            self.ws()
            if self.peek() == ":":  # a single-pair mapping inside [...]
                self.i += 1
                item = {self._as_key(start): self.node(flow=True)}
                self.ws()
            out.append(item)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, found "
                                 f"{self.peek() or 'the end of the line'!r}")

    def _as_key(self, start: int) -> tp.Any:
        keep, self.i = self.i, start
        k = self.key(flow=True)
        self.i = keep
        return k

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.ws()
            if self.peek() == "}":
                self.i += 1
                return out
            k = self.key(flow=True)
            self.ws()
            if self.peek() == ":":
                self.i += 1
                self.ws()
                v = None if self.peek() in tuple(",}") else self.node(flow=True)
            else:
                v = None
            out[k] = v
            self.ws()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, found "
                                 f"{self.peek() or 'the end of the line'!r}")

    def finish(self) -> None:
        self.ws()
        if self.i != len(self.s):
            raise self.error(f"unexpected {self.s[self.i:]!r} after a value")


def _balance(text: str) -> int:
    """Open minus closed flow brackets, outside quotes."""
    depth, quote, i = 0, None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1  # '' is a quote inside the scalar
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


class _Block:
    def __init__(self, lines: tp.Sequence[_Line]):
        self.lines = list(lines)
        self.i = 0

    def inline(self, text: str, line: _Line) -> tp.Any:
        """An inline value; a flow collection may continue on the lines after."""
        while _balance(text) > 0 and self.i < len(self.lines):
            text += " " + self.lines[self.i].text
            self.i += 1
        if text == "-" or text.startswith("- "):
            raise ConfigError(line.no, "a block sequence cannot start after a key on its line")
        f = _Flow(text, line.no)
        value = f.node(flow=False)
        f.finish()
        if self.i < len(self.lines) and self.lines[self.i].indent > line.indent \
                and not isinstance(value, (list, dict)):
            raise ConfigError(self.lines[self.i].no,
                              "a plain scalar over several lines is not supported")
        return value

    def node(self, indent: int) -> tp.Any:
        line = self.lines[self.i]
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(line.indent)
        if _split_key(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self.inline(line.text, line)

    def _nested(self, line: _Line, rest: str, allow_same_indent_seq: bool) -> tp.Any:
        """The value after ``key:`` or ``-``: inline, else the block below."""
        if rest:
            return self.inline(rest, line)
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > line.indent:
                return self.node(nxt.indent)
            if allow_same_indent_seq and nxt.indent == line.indent and \
                    (nxt.text == "-" or nxt.text.startswith("- ")):
                return self.sequence(nxt.indent)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise ConfigError(line.no, "bad indentation in a sequence")
            if not (line.text == "-" or line.text.startswith("- ")):
                break
            rest = line.text[1:]
            offset = len(rest) - len(rest.lstrip(" "))
            rest = rest.strip()
            self.i += 1
            if rest and (rest == "-" or rest.startswith("- ") or
                         _split_key(_Line(line.no, 0, rest)) is not None):
                # the item opens a block on its own line: "- key: v" or "- - x"
                self.i -= 1
                self.lines[self.i] = _Line(line.no, indent + 1 + offset, rest)
                out.append(self.node(indent + 1 + offset))
            else:
                out.append(self._nested(line, rest, False))
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise ConfigError(line.no, "bad indentation in a mapping")
            split = _split_key(line)
            if split is None:
                if line.text == "-" or line.text.startswith("- "):
                    break
                raise ConfigError(line.no, f"expected 'key: value', found {line.text!r}")
            key, rest = split
            if key == "<<":
                raise ConfigError(line.no, "merge keys (<<) are not supported")
            self.i += 1
            out[key] = self._nested(line, rest, True)
        return out


def _split_key(line: _Line) -> tp.Optional[tp.Tuple[tp.Any, str]]:
    """(key, the rest after ``:``) when ``line`` is a block mapping entry."""
    text = line.text
    if text[0] in "[{":
        return None
    f = _Flow(text, line.no)
    if text[0] in "'\"":
        try:
            key = f.key(flow=False)
        except ConfigError:
            return None
        f.ws()
        if f.peek() != ":" or f.s[f.i + 1:f.i + 2] not in ("", " ", "\t"):
            return None
        return key, text[f.i + 1:].strip()
    if text[0] in "!&*|>?%@`" or text == "-" or text.startswith("- "):
        if text[0] in "&*?" and re.match(r"^[&*?]\S*\s*:", text):
            raise ConfigError(line.no, "anchors, aliases and complex keys are not supported")
        return None
    m = re.search(r":(?:\s|$)", text)
    if m is None:
        return None
    return resolve_plain(text[:m.start()].rstrip(), line.no), text[m.end():].strip()


def yaml_load(text: str) -> tp.Any:
    """Parse YAML text (the supported subset, ``!join`` included); an empty
    document is ``{}``, as the JAX loader returns it."""
    lines = _lines(text)
    if not lines:
        return {}
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.i != len(block.lines):
        line = block.lines[block.i]
        raise ConfigError(line.no, f"unexpected {line.text!r} (bad indentation?)")
    return {} if value is None else value


# --------------------------------------------------------------------------- #
#  the writer                                                                 #
# --------------------------------------------------------------------------- #

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./ +-]*$")


def _scalar(v: tp.Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        return s.replace("e", ".0e", 1) if "." not in s and "e" in s else s
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat(" ") if isinstance(v, datetime.datetime) else v.isoformat()
    s = str(v)
    if _PLAIN_SAFE.match(s) and not s.endswith(" ") and resolve_plain(s) == s:
        return s
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    return '"' + "".join(c if c.isprintable() and c not in '"\\' else
                         ("\\" + c if c in '"\\' else f"\\u{ord(c):04x}") for c in s) + '"'


def _dump(v: tp.Any, indent: int, out: tp.List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent, out)
            else:
                out.append(f"{pad}{key}: {_inline(x)}")
    else:
        for x in v:
            if isinstance(x, (dict, list, tuple)) and x:
                sub: tp.List[str] = []
                _dump(x, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(x)}")


def _inline(v: tp.Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def yaml_dump(data: tp.Any) -> str:
    """Block YAML of plain data (mappings, sequences, str, int, float, bool,
    None, dates): PyYAML's ``safe_load`` and ``yaml_load`` read it back to
    ``data``."""
    data = _plain(data)
    if not isinstance(data, (dict, list, tuple)) or not data:
        return _inline(data) + "\n"
    out: tp.List[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"


def _plain(obj: tp.Any) -> tp.Any:
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


# --------------------------------------------------------------------------- #
#  value_select and Config                                                    #
# --------------------------------------------------------------------------- #

def value_select(node: tp.Any, selectors: tp.Sequence[str]) -> tp.Any:
    """Collapse every mapping with a ``default`` key, bottom-up, to the value of
    the first selector it holds, else its ``default``."""
    if isinstance(node, dict):
        node = {k: value_select(v, selectors) for k, v in node.items()}
        if "default" in node:
            for sel in selectors:
                if sel in node:
                    return node[sel]
            return node["default"]
        return node
    if isinstance(node, list):
        return [value_select(v, selectors) for v in node]
    return node


_value_select = value_select


class Config(dict):
    """A config file's mapping with one ``value_select`` applied: nested
    mappings are ``Config`` too, read as items or attributes, with JAX's
    section helpers (``section``, ``trim``, ``drop``, ``find``, ``get_path``,
    ``set_path``) and its content ``hash``."""

    def __init__(self, data: tp.Optional[tp.Mapping] = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = v

    @staticmethod
    def _wrap(v: tp.Any) -> tp.Any:
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        return v

    @classmethod
    def create_from_file(cls, path: tp.Union[str, Path],
                         value_select: tp.Optional[tp.Sequence[str]] = None) -> "Config":
        return cls.create_from_yaml(Path(path).read_text(encoding="utf-8"), value_select)

    @classmethod
    def create_from_yaml(cls, text: str,
                         value_select: tp.Optional[tp.Sequence[str]] = None) -> "Config":
        data = _value_select(yaml_load(text), list(value_select or []))
        if not isinstance(data, dict):
            raise ValueError("a config file must hold a mapping at its top")
        return cls(data)

    def __getattr__(self, name: str) -> tp.Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, self._wrap(value))

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def section(self, name: str, default: tp.Optional[dict] = None) -> "Config":
        """The section ``name``; ``default`` (or an empty one) where it is
        absent or None; ``{name: value}`` where it is not a mapping."""
        val = self.get(name)
        if val is None:
            return Config(default or {})
        return val if isinstance(val, Config) else Config({name: val})

    def trim(self, keep: tp.Sequence[str]) -> "Config":
        """Only the listed top-level sections."""
        return Config({k: v for k, v in self.items() if k in keep})

    def drop(self, remove: tp.Sequence[str]) -> "Config":
        """All but the listed top-level sections."""
        return Config({k: v for k, v in self.items() if k not in remove})

    def find(self, key: str) -> tp.Any:
        """The first non-None value of ``key``, depth first (None if none)."""
        if key in self:
            return self[key]
        for v in self.values():
            if isinstance(v, Config):
                found = v.find(key)
                if found is not None:
                    return found
        return None

    def set_path(self, dotted: str, value: tp.Any) -> None:
        """Set the ``a.b.c`` entry, making the sections on the way (a value that
        is not a mapping on the way is replaced by one)."""
        keys = dotted.split(".")
        node: dict = self
        for k in keys[:-1]:
            if not isinstance(node.get(k), dict):
                node[k] = Config()
            node = node[k]
        node[keys[-1]] = value

    def get_path(self, dotted: str, default: tp.Any = None) -> tp.Any:
        """The ``a.b.c`` entry, else ``default``."""
        node: tp.Any = self
        for k in dotted.split("."):
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    def to_dict(self) -> dict:
        """Plain nested dicts, the values deep-copied."""
        return {k: v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
                for k, v in self.items()}

    def to_yaml(self) -> str:
        return yaml_dump(self.to_dict())

    def to_file(self, path: tp.Union[str, Path]) -> None:
        Path(path).write_text(self.to_yaml(), encoding="utf-8")

    def copy(self) -> "Config":
        return Config(self.to_dict())

    @property
    def hash(self) -> str:
        """16 hex digits of the sha256 of the config's sorted JSON (values JSON
        cannot hold as their ``str``): JAX's digest of the same config."""
        blob = json.dumps(_plain(self), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def change_config_file(path: tp.Union[str, Path], updates: tp.Mapping[str, tp.Any],
                       value_select: tp.Optional[tp.Sequence[str]] = None) -> Config:
    """Read ``path`` (with ``value_select``), set each dotted key of ``updates``,
    write the file back and return the config."""
    cfg = Config.create_from_file(path, value_select=value_select)
    for dotted, value in updates.items():
        cfg.set_path(dotted, value)
    cfg.to_file(path)
    return cfg
