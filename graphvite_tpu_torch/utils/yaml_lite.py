"""A reader for the subset of YAML that the experiment configs use.

`load(text)` returns what `yaml.safe_load` returns on the same text, for
this subset:

* block mappings and block sequences (also a sequence of mappings,
  `- task: ...` with its further keys indented under the first), and a
  sequence written at its parent key's indentation;
* flow sequences on one line (`portions: [0.1, 0.2]`, `[]`);
* single- and double-quoted scalars on one line (a double-quoted one
  without escapes), full-line and trailing comments, one leading `---`.

Plain scalars resolve as PyYAML resolves them, which is YAML 1.1: `yes`,
`no`, `on`, `off`, `true` and `false` in their three spellings are bools;
`~`, `null` and an empty value are None; a float needs a dot, and its
exponent a sign, so `5e-06` stays the string "5e-06" while `5.0e-3` is a
float; ints may be octal (`017`), hex, binary or base 60 (`1:30`).

Anything else raises `YAMLSubsetError` naming the line, rather than
being misread: anchors and aliases, tags, block scalars (`|`, `>`), flow
mappings, complex keys, multi-line plain or quoted scalars, escapes in
double-quoted scalars, timestamps, merge keys, more than one document,
tabs in the indentation.
"""
from __future__ import annotations

import re

__all__ = ["YAMLSubsetError", "load", "load_file"]


class YAMLSubsetError(ValueError):
    """The text lies outside the subset this reader supports, or is not
    valid YAML."""


# PyYAML's implicit resolvers (YAML 1.1), the regular expressions as it
# writes them
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)

# characters that cannot start a plain scalar, and what each would begin
_UNSUPPORTED_START = {
    "&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
    ">": "block scalars", "{": "flow mappings", "%": "directives",
    "@": "reserved indicators", "`": "reserved indicators",
}


def _sexagesimal(value, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _int(value):
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
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value):
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Parser:

    def __init__(self, text):
        # [indent, content, line number] of every line that holds content
        self.lines = []
        for number, raw in enumerate(text.splitlines(), 1):
            self.number = number
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                self.fail("tabs in the indentation are not supported")
            content = self.strip_comment(stripped)
            if content:
                self.lines.append([len(body) - len(stripped), content,
                                   number])
        self.pos = 0

    def fail(self, message, number=None):
        raise YAMLSubsetError("line %d: %s" % (number or self.number,
                                               message))

    def strip_comment(self, text):
        """`text` without its comment: a `#` at the start or after a blank,
        outside a quoted scalar."""
        depth = i = 0
        while i < len(text):
            c = text[i]
            if c == "#" and (i == 0 or text[i - 1] in " \t"):
                return text[:i].rstrip()
            if c in "'\"[" and self.token_start(text, i, depth):
                if c != "[":
                    i = self.quoted_end(text, i) + 1
                    continue
                depth += 1
            elif c == "]" and depth:
                depth -= 1
            i += 1
        return text

    @staticmethod
    def token_start(text, i, depth):
        """Whether a quote or bracket at text[i] opens a node: at the start
        of the line, after an entry's `- ` or a key's `: `, or after `[`
        or `,` inside a flow sequence (elsewhere it is part of a plain
        scalar)."""
        prefix = text[:i]
        p = prefix.rstrip(" ")
        if not p or (depth and p[-1] in "[,"):
            return True
        if len(p) == len(prefix):
            return False
        return p[-1] == ":" or re.fullmatch(r"(?:- +)*-", p) is not None

    def quoted_end(self, text, start):
        """Index of the quote that closes the scalar opened at `start`."""
        quote = text[start]
        i = start + 1
        while i < len(text):
            c = text[i]
            if quote == "'" and c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 2
                    continue
                return i
            if quote == '"':
                if c == "\\":
                    self.fail("escapes in double-quoted scalars are not "
                              "supported")
                if c == '"':
                    return i
            i += 1
        self.fail("multi-line quoted scalars are not supported")

    # -- scalars -------------------------------------------------------------
    def quoted(self, text):
        quote = text[0]
        end = self.quoted_end(text, 0)
        if text[end + 1:].strip():
            self.fail("unexpected text after a quoted scalar: %r" % text)
        body = text[1:end]
        if quote == "'":
            return body.replace("''", "'")
        return body

    def plain(self, text):
        """Resolve a plain scalar as PyYAML does."""
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _INT.match(text):
            return _int(text)
        if _FLOAT.match(text):
            return _float(text)
        if _TIMESTAMP.match(text):
            self.fail("timestamps are not supported: %r" % text)
        if text in ("<<", "="):
            self.fail("merge keys and value keys are not supported")
        return text

    def check_plain_start(self, text):
        c = text[0]
        if c in _UNSUPPORTED_START:
            self.fail("%s are not supported: %r" % (_UNSUPPORTED_START[c],
                                                     text))
        if c in "?:-" and (len(text) == 1 or text[1] == " "):
            self.fail("unexpected indicator %r in %r" % (c, text))

    def scalar(self, text):
        """A value written on the line of its key or sequence entry."""
        if text[0] in "'\"":
            return self.quoted(text)
        if text[0] == "[":
            items, end = self.flow_sequence(text, 0)
            if text[end:].strip():
                self.fail("unexpected text after a flow sequence: %r" % text)
            return items
        self.check_plain_start(text)
        if ": " in text or text.endswith(":"):
            self.fail("mapping values are not allowed here: %r" % text)
        return self.plain(text)

    def flow_sequence(self, text, start):
        """Parse `[a, b, ...]` from text[start]; returns (list, index past
        the closing bracket)."""
        items = []
        i = start + 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i == len(text):
                self.fail("multi-line flow sequences are not supported")
            c = text[i]
            if c == "]":
                return items, i + 1
            if c == ",":
                self.fail("empty entry in a flow sequence: %r" % text)
            if c == "[":
                item, i = self.flow_sequence(text, i)
            elif c in "'\"":
                end = self.quoted_end(text, i)
                item = self.quoted(text[i:end + 1])
                i = end + 1
            else:
                j = i
                while j < len(text) and text[j] not in ",[]{}":
                    j += 1
                token = text[i:j].rstrip()
                self.check_plain_start(token)
                if ":" in token and re.search(r":(\s|$)", token):
                    self.fail("flow mappings are not supported: %r" % text)
                item = self.plain(token)
                i = j
            items.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i < len(text) and text[i] != "]":
                self.fail("bad flow sequence: %r" % text)

    # -- blocks --------------------------------------------------------------
    def split_key(self, content):
        """(key, rest) of a mapping entry `key: rest`, or None where the
        line is not one."""
        if content[0] in "'\"":
            end = self.quoted_end(content, 0)
            after = content[end + 1:].lstrip(" ")
            if not after.startswith(":") or after[1:2] not in ("", " "):
                return None
            return self.quoted(content[:end + 1]), after[1:].strip()
        if content[0] in "[{":
            return None
        m = re.search(r":( |$)", content)
        if m is None:
            return None
        key = content[:m.start()].rstrip()
        if not key:
            self.fail("empty keys are not supported")
        self.check_plain_start(key)
        return self.plain(key), content[m.end():].strip()

    @staticmethod
    def is_entry(content):
        return content == "-" or content.startswith("- ")

    def block(self, indent):
        """The node whose first line is the current one, at `indent`."""
        _, content, number = self.lines[self.pos]
        self.number = number
        if self.is_entry(content):
            return self.sequence(indent)
        if self.split_key(content) is not None:
            return self.mapping(indent)
        value = self.scalar(content)
        self.pos += 1
        self.check_dedent(indent)
        return value

    def check_dedent(self, indent):
        """After a one-line node at `indent`, no line may be deeper (it
        would continue a multi-line scalar)."""
        if self.pos < len(self.lines) and self.lines[self.pos][0] > indent:
            self.fail("unexpected indentation (multi-line scalars are not "
                      "supported)", self.lines[self.pos][2])

    def nested(self, indent, allow_entries):
        """The value of a key or entry with nothing after its indicator:
        a deeper block, a sequence at the key's own indentation, or
        None."""
        if self.pos == len(self.lines):
            return None
        next_indent, content, _ = self.lines[self.pos]
        if next_indent > indent:
            return self.block(next_indent)
        if allow_entries and next_indent == indent and self.is_entry(content):
            return self.sequence(indent)
        return None

    def sequence(self, indent):
        items = []
        while self.pos < len(self.lines):
            line_indent, content, number = self.lines[self.pos]
            if line_indent != indent or not self.is_entry(content):
                break
            self.number = number
            rest = content[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                items.append(self.nested(indent, False))
                continue
            # the entry's content is a node of its own at its column
            self.lines[self.pos] = [indent + len(content) - len(rest), rest,
                                    number]
            items.append(self.block(self.lines[self.pos][0]))
        self.check_dedent(indent)
        return items

    def mapping(self, indent):
        out = {}
        while self.pos < len(self.lines):
            line_indent, content, number = self.lines[self.pos]
            if line_indent != indent:
                break
            self.number = number
            entry = self.split_key(content)
            if entry is None:
                self.fail("expected `key: value`, got %r" % content)
            key, rest = entry
            self.pos += 1
            if rest:
                out[key] = self.scalar(rest)
                self.check_dedent(indent)
            else:
                out[key] = self.nested(indent, True)
        self.check_dedent(indent)
        return out

    def document(self):
        lines = self.lines
        if lines and lines[0][1].startswith("%"):
            self.fail("directives are not supported", lines[0][2])
        if lines and lines[0][1] == "---" and lines[0][0] == 0:
            self.pos = 1
        for line in lines[self.pos:]:
            if line[1] in ("---", "...") or line[1].startswith("--- "):
                self.fail("more than one document, or a document marker, "
                          "is not supported", line[2])
        if self.pos == len(lines):
            return None
        node = self.block(lines[self.pos][0])
        if self.pos < len(lines):
            self.fail("unexpected content %r" % lines[self.pos][1],
                      lines[self.pos][2])
        return node


def load(text):
    """Parse YAML text in the configs' subset: what yaml.safe_load gives."""
    return _Parser(text).document()


def load_file(file_name):
    with open(file_name) as f:
        return load(f.read())
