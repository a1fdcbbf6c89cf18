"""Read the run configs (``configs/*.yaml``) without PyYAML.

The GPU machine has no ``yaml`` package, so the CLI reads its configs with
:func:`load_config`, a reader for the subset of YAML that the shipped
configs and ``yaml.safe_dump`` use:

- block mappings and block lists (list items at the key's indent or
  deeper, as ``safe_dump`` writes them), and list items that open a
  mapping (``- dim: 16`` then ``  depth: 1``);
- flow mappings and flow lists on one line (``- {dim: 48, depth: 1}``);
- scalars resolved as ``yaml.safe_load`` resolves them: decimal ints,
  floats with a dot (``1.0e-06``, ``.5``, ``.inf``, ``.nan``), the YAML 1.1
  booleans (``true``/``false``, ``yes``/``no``, ``on``/``off``), ``null``,
  ``~`` or nothing, plain, single- or double-quoted strings;
- comments, whole-line or after a space.

Anything else raises :class:`ConfigError` naming the line: anchors,
aliases, tags, block scalars, multi-document streams, multi-line flow
collections or plain scalars, octal, hex and sexagesimal numbers,
timestamps, duplicate keys. It never falls back to another parser.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, Tuple, Union

# the resolvers of PyYAML's SafeLoader (yaml/resolver.py), for the forms kept
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# forms safe_load resolves that this reader refuses
_REFUSED = (
    (re.compile(r"^[-+]?0b[0-1_]+$"), "a binary int"),
    (re.compile(r"^[-+]?0[0-7_]+$"), "an octal int"),
    (re.compile(r"^[-+]?0x[0-9a-fA-F_]+$"), "a hex int"),
    (re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"),
     "a sexagesimal number"),
    (re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"), "a date"),
    (re.compile(r"^<<$"), "a merge key"),
    (re.compile(r"^=$"), "a value key"),
)
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0", " ": " "}


class ConfigError(ValueError):
    """The text is not in the YAML subset :func:`load_config` reads."""


def resolve_scalar(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it (the forms kept)."""
    if _NULL.match(text):
        return None
    if _TRUE.match(text):
        return True
    if _FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) or _INF_NAN.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    for pattern, what in _REFUSED:
        if pattern.match(text):
            raise ConfigError(f"{text!r} is {what}: not read")
    return text


class _Parser:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[Tuple[int, str, int]] = []  # (indent, text, lineno)
        for no, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise self.error(no, "a tab in the indentation")
            if stripped.startswith(("%", "---", "...")):
                raise self.error(no, "a directive or document marker")
            self.lines.append((len(body) - len(stripped), stripped, no))

    def error(self, lineno: int, what: str) -> ConfigError:
        return ConfigError(f"{self.source}:{lineno}: {what} (not in the "
                           "YAML subset load_config reads)")

    @staticmethod
    def _strip_comment(line: str) -> str:
        """The line without a comment: '#' at its start or after a space,
        outside quotes."""
        quote, i = None, 0
        while i < len(line):
            ch = line[i]
            if quote:
                if ch == "\\" and quote == '"' or line[i:i + 2] == "''":
                    i += 1  # an escaped quote does not end the string
                elif ch == quote:
                    quote = None
            elif ch in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
                quote = ch
            elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i]
            i += 1
        return line

    # ---- block structure ------------------------------------------------

    def parse(self) -> Any:
        if not self.lines:
            return None
        if self.lines[0][1][0] in "{[" and len(self.lines) == 1:
            return self.inline(self.lines[0][1], self.lines[0][2])
        value, i = self.block(0, self.lines[0][0])
        if i != len(self.lines):
            raise self.error(self.lines[i][2], "unexpected indentation")
        return value

    def block(self, i: int, indent: int):
        text = self.lines[i][1]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def _child(self, i: int, indent: int, lineno: int, in_mapping: bool):
        """The value of a key or item whose inline text is empty: a nested
        block below it, a list at the key's own indent, or null."""
        if i < len(self.lines):
            nxt_indent, nxt, _ = self.lines[i]
            if nxt_indent > indent:
                return self.block(i, nxt_indent)
            if (in_mapping and nxt_indent == indent
                    and (nxt == "-" or nxt.startswith("- "))):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines):
            ind, text, no = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise self.error(no, "unexpected indentation")
            if text == "-" or text.startswith("- "):
                break
            key, rest = self.split_key(text, no)
            if key in out:
                raise self.error(no, f"duplicate key {key!r}")
            if rest:
                out[key] = self.inline(rest, no)
                i += 1
            else:
                out[key], i = self._child(i + 1, indent, no, True)
        return out, i

    def sequence(self, i: int, indent: int):
        out = []
        while i < len(self.lines):
            ind, text, no = self.lines[i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise self.error(no, "unexpected indentation")
                break
            rest = text[1:].lstrip(" ")
            if not rest:
                value, i = self._child(i + 1, indent, no, False)
            elif (rest == "-" or rest.startswith("- ")
                  or rest[0] not in "{['\"" and self._key_colon(rest) >= 0):
                # "- key: value" opens a mapping at the key's column, and
                # "- - item" a list at the inner dash's
                col = indent + len(text) - len(rest)
                self.lines[i] = (col, rest, no)
                value, i = self.block(i, col)
            else:
                value = self.inline(rest, no)
                i += 1
            out.append(value)
        return out, i

    # ---- one line ---------------------------------------------------------

    @staticmethod
    def _key_colon(text: str) -> int:
        """Index of the ':' that ends a plain key (':' then a space or the
        end of the line), or -1."""
        for j, ch in enumerate(text):
            if ch == ":" and (j + 1 == len(text) or text[j + 1] == " "):
                return j
        return -1

    def split_key(self, text: str, no: int):
        if text[0] in "'\"":
            key, j = self.quoted(text, 0, no)
            rest = text[j:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                raise self.error(no, "a quoted key without ':'")
            return key, rest[1:].strip()
        j = self._key_colon(text)
        if j <= 0:
            raise self.error(no, f"no 'key: value' in {text!r}")
        key = self.plain(text[:j].rstrip(), no)
        if isinstance(key, (dict, list)):
            raise self.error(no, "a complex key")
        return key, text[j + 1:].strip()

    def inline(self, text: str, no: int) -> Any:
        if text[0] in "{[":
            value, j = self.flow(text, 0, no)
            if text[j:].strip():
                raise self.error(no, f"text after a flow collection: "
                                 f"{text[j:]!r}")
            return value
        if text[0] in "'\"":
            value, j = self.quoted(text, 0, no)
            if text[j:].strip():
                raise self.error(no, f"text after a quoted string: "
                                 f"{text[j:]!r}")
            return value
        return self.plain(text, no)

    def plain(self, text: str, no: int) -> Any:
        if text[0] in "&*!|>%@`" or text.startswith(("? ", "- ", ": ")):
            raise self.error(no, f"an indicator at the start of {text!r}")
        if ": " in text or text.endswith(":") or " #" in text:
            raise self.error(no, f"a plain scalar with ': ' or ' #': "
                             f"{text!r}")
        try:
            return resolve_scalar(text)
        except ConfigError as e:
            raise self.error(no, str(e)) from None

    def quoted(self, text: str, j: int, no: int):
        q = text[j]
        out, j = [], j + 1
        while j < len(text):
            ch = text[j]
            if ch == q:
                if q == "'" and text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and ch == "\\":
                esc = text[j + 1:j + 2]
                if esc not in _ESCAPES:
                    raise self.error(no, f"the escape \\{esc}")
                out.append(_ESCAPES[esc])
                j += 2
                continue
            out.append(ch)
            j += 1
        raise self.error(no, "a quoted string that does not end on its "
                         "line")

    def flow(self, text: str, j: int, no: int):
        """A flow mapping or list starting at text[j]; (value, end)."""
        mapping = text[j] == "{"
        close = "}" if mapping else "]"
        out: Union[dict, list] = {} if mapping else []
        j += 1
        while True:
            j = self._skip(text, j)
            if j >= len(text):
                raise self.error(no, "a flow collection that does not end "
                                 "on its line")
            if text[j] == close:
                return out, j + 1
            if mapping:
                key, j = self.flow_scalar(text, j, no, key=True)
                j = self._skip(text, j)
                if text[j:j + 1] != ":":
                    raise self.error(no, "a flow mapping entry without ':'")
                j = self._skip(text, j + 1)
                if text[j:j + 1] in (",", "}"):
                    value = None
                else:
                    value, j = self.flow_scalar(text, j, no)
                if key in out:
                    raise self.error(no, f"duplicate key {key!r}")
                out[key] = value
            else:
                value, j = self.flow_scalar(text, j, no)
                out.append(value)
            j = self._skip(text, j)
            if text[j:j + 1] == ",":
                j += 1
            elif text[j:j + 1] != close:
                raise self.error(no, f"expected ',' or '{close}' in a flow "
                                 "collection")

    @staticmethod
    def _skip(text: str, j: int) -> int:
        while j < len(text) and text[j] == " ":
            j += 1
        return j

    def flow_scalar(self, text: str, j: int, no: int, key: bool = False):
        if text[j] in "{[":
            if key:
                raise self.error(no, "a complex key")
            return self.flow(text, j, no)
        if text[j] in "'\"":
            return self.quoted(text, j, no)
        end = j
        while end < len(text) and text[end] not in ",{}[]":
            if text[end] == ":" and (end + 1 == len(text)
                                     or text[end + 1] in " ,}]"):
                break
            end += 1
        token = text[j:end].strip()
        if not token:
            raise self.error(no, "an empty flow entry")
        return self.plain(token, no), end


def parse_config(text: str, source: str = "<string>") -> Any:
    """The document in ``text`` (see the module docstring for the subset)."""
    return _Parser(text, source).parse()


def load_config(path: Union[str, Path]) -> dict:
    """The config at ``path`` as ``yaml.safe_load(f) or {}`` reads it."""
    path = Path(path)
    value = parse_config(path.read_text(encoding="utf-8"), str(path))
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise ConfigError(f"{path}: the document is not a mapping")
    return value
