"""A reader for the subset of YAML the config files use.

The machine the port runs on has no PyYAML, so the port reads its config
files itself. :func:`safe_load` gives what ``yaml.safe_load`` gives on:

* block mappings and block sequences (a sequence may sit at its key's
  indentation, and an entry may open a compact mapping: ``- key: value``);
* flow sequences and mappings on one line (``[0.9, 0.999]``, ``{}``);
* ``#`` comments, on their own line or after a value;
* plain, single-quoted and double-quoted scalars (``"true"`` is the
  string, ``true`` the bool);
* YAML 1.1's implicit types as PyYAML resolves them: null (``~``,
  ``null``, empty), booleans (``yes``/``no``/``on``/``off``/``true``/
  ``false`` in three casings), ints (decimal, ``0b``, ``0x``, octal with a
  leading 0, ``_`` separators, base 60), floats *with a dot* (``1.0e-4``,
  ``.5``, ``.inf``, ``.nan``). A float without a dot (``2e-4``, ``1e-06``)
  stays a string, as in PyYAML.

Anything else (anchors and aliases, tags, block scalars ``|``/``>``,
multi-line plain or flow scalars, escapes in double-quoted scalars,
complex keys, directives, document markers, timestamps, tabs in
indentation) raises :class:`YAMLSubsetError`
with the source name and line; it is never guessed.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """Input outside the supported subset, or malformed."""


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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_UNSUPPORTED_START = "&*!|>%@`?"


def _sexagesimal(digits: str, cast) -> Any:
    total = 0
    for part in digits.split(":"):
        total = total * 60 + cast(part)
    return total


def _resolve_int(text: str) -> int:
    value = text.replace("_", "")
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
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _resolve_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        # (line number, indent, content without its comment)
        self.lines: List[Tuple[int, int, str]] = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            content = self._strip_comment(raw)
            body = content.lstrip(" ")
            if not body.strip():
                continue
            if body[0] == "\t":
                self.fail(lineno, "tab in indentation")
            if body.startswith(("---", "...")) and (
                    len(body) == 3 or body[3] in " \t"):
                self.fail(lineno, "document markers are not supported")
            self.lines.append((lineno, len(content) - len(body), body.rstrip()))
        self.pos = 0

    def fail(self, lineno: int, msg: str):
        raise YAMLSubsetError(f"{self.source}:{lineno}: {msg}")

    @staticmethod
    def _strip_comment(raw: str) -> str:
        quote = None
        i = 0
        while i < len(raw):
            c = raw[i]
            if quote == "'":
                if c == "'":
                    if raw[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
            elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:-"):
                quote = c
            i += 1
        return raw

    # ------------------------------------------------------------------
    # block structure
    # ------------------------------------------------------------------

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def document(self) -> Any:
        if not self.lines:
            return None
        lineno, indent, _ = self.lines[0]
        node = self.node(indent, parent_indent=-1)
        if self.pos < len(self.lines):
            self.fail(self.lines[self.pos][0], "unexpected indentation")
        return node

    def node(self, indent: int, parent_indent: int) -> Any:
        lineno, ind, text = self.peek()
        if ind != indent:
            self.fail(lineno, "unexpected indentation")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if self.split_key(text, lineno) is not None:
            return self.mapping(indent)
        self.pos += 1
        value = self.inline(text, lineno)
        self.no_continuation(parent_indent)
        return value

    def no_continuation(self, indent: int) -> None:
        """A scalar's next line must not be more indented than its owner:
        that would continue it (a multi-line scalar)."""
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            self.fail(nxt[0], "multi-line scalars are not supported")

    def value_after(self, indent: int) -> Any:
        """The block value of an entry with nothing after its indicator."""
        nxt = self.peek()
        if nxt is None or nxt[1] < indent:
            return None
        if nxt[1] > indent:
            return self.node(nxt[1], indent)
        return None

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            if line is None or line[1] != indent or not (
                    line[2] == "-" or line[2].startswith("- ")):
                break
            lineno, _, text = line
            rest = text[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                items.append(self.value_after(indent))
                continue
            # the entry's content is a node at the column it starts in
            col = indent + len(text) - len(rest)
            self.lines[self.pos] = (lineno, col, rest)
            items.append(self.node(col, indent))
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            self.fail(nxt[0], "unexpected indentation")
        return items

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line[1] != indent:
                break
            lineno, _, text = line
            split = self.split_key(text, lineno)
            if split is None:
                self.fail(lineno, "expected a 'key: value' entry")
            key, rest = split
            self.pos += 1
            if rest:
                out[key] = self.inline(rest, lineno)
                self.no_continuation(indent)
                continue
            nxt = self.peek()
            if nxt is not None and nxt[1] == indent and (
                    nxt[2] == "-" or nxt[2].startswith("- ")):
                out[key] = self.sequence(indent)
            else:
                out[key] = self.value_after(indent)
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            self.fail(nxt[0], "unexpected indentation")
        return out

    def split_key(self, text: str, lineno: int) -> Optional[Tuple[Any, str]]:
        """(key, rest) of a 'key: rest' line, or None if it is not one."""
        if text[0] in "[{":
            return None
        if text[0] in "'\"":
            key, end = self.quoted(text, 0, lineno)
            tail = text[end:].lstrip(" ")
            if tail == ":" or tail.startswith(": "):
                return key, tail[1:].strip()
            return None
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        key = text[:m.start()].rstrip()
        if not key:
            self.fail(lineno, "empty keys are not supported")
        return self.plain(key, lineno), text[m.end():].strip()

    # ------------------------------------------------------------------
    # scalars and flow collections on one line
    # ------------------------------------------------------------------

    def inline(self, text: str, lineno: int) -> Any:
        if text[0] in "[{":
            value, end = self.flow(text, 0, lineno)
            if text[end:].strip():
                self.fail(lineno, f"unexpected text after a flow collection: "
                                  f"{text[end:].strip()!r}")
            return value
        if text[0] in "'\"":
            value, end = self.quoted(text, 0, lineno)
            if text[end:].strip():
                self.fail(lineno, "unexpected text after a quoted scalar")
            return value
        if re.search(r":(?: |$)", text):
            self.fail(lineno, "mapping values are not allowed here")
        return self.plain(text, lineno)

    def plain(self, text: str, lineno: int) -> Any:
        text = text.strip()
        if text and (text[0] in _UNSUPPORTED_START or text == "-"
                     or text.startswith("- ")):
            self.fail(lineno, f"unsupported YAML syntax {text!r} (anchors, "
                              f"aliases, tags, block scalars, complex keys "
                              f"and directives are not supported)")
        if text in ("<<", "="):
            self.fail(lineno, f"unsupported YAML key {text!r}")
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _resolve_float(text)
        if _INT.match(text):
            return _resolve_int(text)
        if _TIMESTAMP.match(text):
            self.fail(lineno, f"timestamps are not supported: {text!r}")
        return text

    def quoted(self, text: str, i: int, lineno: int) -> Tuple[str, int]:
        q = text[i]
        out = []
        j = i + 1
        while j < len(text):
            c = text[j]
            if q == "'" and c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                self.fail(lineno, "escapes in double-quoted scalars are not "
                                  "supported")
            out.append(c)
            j += 1
        self.fail(lineno, "multi-line quoted scalars are not supported")

    def flow(self, text: str, i: int, lineno: int) -> Tuple[Any, int]:
        opener = text[i]
        closer = "]" if opener == "[" else "}"
        items: Any = [] if opener == "[" else {}
        j = i + 1
        while True:
            j = self.skip_spaces(text, j)
            if j >= len(text):
                self.fail(lineno, "multi-line flow collections are not "
                                  "supported")
            if text[j] == closer:
                return items, j + 1
            if opener == "[":
                value, j = self.flow_node(text, j, lineno, key=False)
                items.append(value)
            else:
                key, j = self.flow_node(text, j, lineno, key=True)
                j = self.skip_spaces(text, j)
                value = None
                if j < len(text) and text[j] == ":":
                    value, j = self.flow_node(text, j + 1, lineno, key=False)
                items[key] = value
            j = self.skip_spaces(text, j)
            if j < len(text) and text[j] == ",":
                j += 1
            elif j < len(text) and text[j] != closer:
                self.fail(lineno, f"expected ',' or '{closer}' in a flow "
                                  f"collection")

    def flow_node(self, text: str, j: int, lineno: int, key: bool
                  ) -> Tuple[Any, int]:
        """A node inside a flow collection; a plain scalar ends at ',',
        ']', '}' or at a ':' that starts a value."""
        j = self.skip_spaces(text, j)
        if j >= len(text):
            self.fail(lineno, "multi-line flow collections are not supported")
        if text[j] in "[{":
            return self.flow(text, j, lineno)
        if text[j] in "'\"":
            return self.quoted(text, j, lineno)
        k = j
        while k < len(text) and text[k] not in ",]}" and not (
                text[k] == ":" and (k + 1 == len(text) or text[k + 1] in " ,]}")):
            if text[k] in "[{":
                self.fail(lineno, "unexpected '[' or '{' in a plain scalar")
            k += 1
        if not key and k < len(text) and text[k] == ":":
            self.fail(lineno, "mappings inside flow sequences and nested "
                              "':' are not supported")
        return self.plain(text[j:k], lineno), k

    @staticmethod
    def skip_spaces(text: str, j: int) -> int:
        while j < len(text) and text[j] == " ":
            j += 1
        return j


def safe_load(text: str, source: str = "<string>") -> Any:
    """Parse one YAML document of the supported subset."""
    return _Reader(text, source).document()


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return safe_load(f.read(), path)
