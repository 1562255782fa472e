"""Config files: YAML -> attribute-access dicts (port of
``mixdq_tpu/utils/config.py``), with a reader and writer of their own.

The card has no YAML library, so this module reads and writes the subset
of YAML that ``configs/*.yaml`` use, and ``load_config`` of such a file
equals ``yaml.safe_load`` of it:

* block maps nested by indentation (spaces only), keys bare or quoted;
* scalars: decimal ints, floats with a dot (``0.5``, ``1.0e-5``, ``.inf``,
  ``.nan``), ``true`` / ``false``, ``null`` / ``~`` / nothing, bare and
  quoted strings (YAML 1.1 resolution, as PyYAML does: ``1e-5`` is a
  string);
* flow lists of scalars (``[2, 4, 8]``) and block lists of scalars
  (``- x``), the latter also at the indent of their key, as PyYAML writes
  them;
* full-line comments and ``#`` comments after a value.

Anything else (anchors, aliases, tags, flow maps, nested lists, block
scalars, documents, YAML 1.1 forms such as ``yes`` / ``0x1f`` / ``1_000``)
raises ``ValueError`` naming the file and line. ``save_config`` writes
the same subset (flow lists, quoted strings where a bare one would read
back as another type), which ``yaml.safe_load`` reads back equal.

The JAX package's platform hook (``apply_platform_env``) is not part of
the port: its device is explicit.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Mapping, Tuple


class Config(dict):
    """A dict with attribute access that wraps nested dicts on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, name: str) -> Any:
        v = super().__getitem__(name)
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            super().__setitem__(name, v)
        return v

    def get(self, name: str, default: Any = None) -> Any:
        try:
            return self[name]
        except KeyError:
            return default


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(loads(f.read(), path))


def save_config(cfg: Mapping, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(cfg))


def merge(base: Mapping, override: Mapping) -> Config:
    out = Config({k: v for k, v in base.items()})
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Scalars (PyYAML's YAML 1.1 resolvers, restricted to the subset)
# ---------------------------------------------------------------------------

_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
#: YAML 1.1 booleans outside the subset
_BOOL_11 = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off",
            "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
#: YAML 1.1 forms PyYAML resolves to numbers that the subset leaves out
#: (binary, octal, hex, underscores, sexagesimal)
_NUM_11 = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?[0-9][0-9_]*|[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?")
#: first characters of a plain scalar that YAML reserves
_INDICATORS = set("[]{}&*!|>%@`'\",#")


class _Error(ValueError):
    pass


def _plain(text: str) -> Any:
    """The value of a bare scalar."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _BOOL_11:
        raise _Error(f"YAML 1.1 boolean {text!r} (write true / false)")
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _NUM_11.fullmatch(text) and any(c.isdigit() for c in text):
        raise _Error(f"number {text!r} outside the subset")
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", ": ")) \
            or text in ("-", "?", "---", "...") or ": " in text \
            or text.endswith(":"):
        raise _Error(f"unsupported YAML construct {text!r}")
    return text


_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0"}


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[i]`` and the index after it."""
    q = text[i]
    out, j = [], i + 1
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
            e = text[j + 1:j + 2]
            if e not in _ESCAPES:
                raise _Error(f"escape \\{e} outside the subset")
            out.append(_ESCAPES[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise _Error("unterminated quoted string")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``# comment`` (a ``#`` after a space, or
    at the start, outside quotes) and without trailing spaces."""
    i, quote = 0, None
    while i < len(text):
        c = text[i]
        if quote:
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
            elif quote == '"' and c == "\\":
                i += 1
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar(text: str) -> Any:
    """A scalar value: quoted or bare."""
    if text[:1] in ("'", '"'):
        s, end = _quoted(text, 0)
        if text[end:].strip():
            raise _Error(f"text after a quoted string: {text!r}")
        return s
    return _plain(text)


def _value(text: str) -> Any:
    """A value after ``key:`` or ``- ``: a flow list or a scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise _Error(f"flow list not closed on its line: {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items, i = [], 0
        while i <= len(inner):
            while inner[i:i + 1] == " ":
                i += 1
            j = i
            if inner[i:i + 1] in ("'", '"'):
                _, j = _quoted(inner, i)
            k = inner.find(",", j)
            k = len(inner) if k < 0 else k
            item = inner[i:k].strip()
            if not item or item[0] in "[{":
                raise _Error(f"nested or empty flow item in {text!r}")
            items.append(_scalar(item))
            i = k + 1
        return items
    if text.startswith("{"):
        raise _Error(f"flow map outside the subset: {text!r}")
    return _scalar(text)


def _key(text: str) -> Tuple[str, str]:
    """(key, rest after ``:``) of a map line, or raises."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:]
        if not rest.startswith(":"):
            raise _Error(f"no ':' after the quoted key in {text!r}")
        rest = rest[1:]
    else:
        m = re.match(r"([^\s:#'\"\[\]{},&*!|>%@`][^:#]*?):(?:\s|$)",
                     text + " ")
        if m is None:
            raise _Error(f"not a 'key: value' line: {text!r}")
        key = _plain(m.group(1))
        if not isinstance(key, str):
            raise _Error(f"non-string key {m.group(1)!r}")
        rest = text[m.end() - 1:]
    if rest and not rest[0].isspace():
        raise _Error(f"no space after ':' in {text!r}")
    return key, rest.strip()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def loads(text: str, path: str = "<string>") -> Any:
    """Parse the YAML subset; errors name ``path`` and the line."""
    lines: List[Tuple[int, int, str]] = []  # (line no., indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        try:
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise _Error("tab in indentation")
            body = _strip_comment(raw.strip())
            if body in ("---", "...") or body.startswith("%"):
                raise _Error(f"document marker or directive {body!r}")
        except _Error as e:
            raise ValueError(f"{path}:{no}: {e}") from None
        if body:
            lines.append((no, len(raw) - len(raw.lstrip(" ")), body))
    if not lines:
        return None
    pos = 0

    def fail(no, msg):
        raise ValueError(f"{path}:{no}: {msg}")

    def block(indent: int) -> Any:
        """The block (map or list) whose lines start at ``indent``."""
        nonlocal pos
        no, ind, body = lines[pos]
        if body == "-" or body.startswith("- "):
            return seq(indent)
        out: dict = {}
        while pos < len(lines):
            no, ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                fail(no, "unexpected indentation")
            if body == "-" or body.startswith("- "):
                fail(no, "list item inside a map")
            try:
                key, rest = _key(body)
            except _Error as e:
                fail(no, e)
            if key in out:
                fail(no, f"duplicate key {key!r}")
            pos += 1
            if rest:
                try:
                    out[key] = _value(rest)
                except _Error as e:
                    fail(no, e)
                continue
            # a nested block: deeper lines, or a list at the same indent
            if pos < len(lines):
                nno, nind, nbody = lines[pos]
                is_item = nbody == "-" or nbody.startswith("- ")
                if nind > indent or (nind == indent and is_item):
                    out[key] = (seq(nind) if is_item else block(nind))
                    continue
            out[key] = None
        return out

    def seq(indent: int) -> List[Any]:
        nonlocal pos
        out = []
        while pos < len(lines):
            no, ind, body = lines[pos]
            if ind != indent or not (body == "-" or body.startswith("- ")):
                if ind > indent:
                    fail(no, "unexpected indentation in a list")
                break
            item = body[1:].strip()
            pos += 1
            if not item or item == "-" or item.startswith(("- ", "[")):
                fail(no, "nested or empty block list item")
            if re.match(r"[^'\"].*?:(\s|$)", item):
                fail(no, f"map inside a list: {item!r}")
            try:
                out.append(_scalar(item))
            except _Error as e:
                fail(no, e)
        return out

    if lines[0][1] != 0:
        fail(lines[0][0], "the document must start at column 0")
    result = block(0)
    if pos < len(lines):
        fail(lines[pos][0], "unexpected line")
    return result


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _dump_str(s: str) -> str:
    try:
        bare = s and s == s.strip() and "\n" not in s and \
            _strip_comment(s) == s and _plain(s) == s
    except _Error:
        bare = False
    if bare:
        return s
    if any(ord(c) < 32 for c in s):
        raise ValueError(f"control characters in {s!r}")
    return "'" + s.replace("'", "''") + "'"


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:  # YAML 1.1 needs a dot and a signed exponent
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        return r
    if isinstance(v, str):
        return _dump_str(v)
    raise ValueError(f"cannot write {type(v).__name__} {v!r}")


def _dump_item(v: Any) -> str:
    """A flow list item: a string holding a flow indicator is quoted."""
    if isinstance(v, str) and any(c in v for c in ",[]{}"):
        return "'" + v.replace("'", "''") + "'"
    return _dump_scalar(v)


def _dump_key(k: Any) -> str:
    if not isinstance(k, str):
        raise ValueError(f"non-string key {k!r}")
    return _dump_str(k)


def dumps(obj: Any) -> str:
    """The YAML subset text of ``obj`` (maps nested by two spaces, lists
    as flow lists of scalars)."""
    out: List[str] = []

    def emit(node: Any, indent: int) -> None:
        pad = " " * indent
        for k, v in node.items():
            if isinstance(v, Mapping):
                if v:
                    out.append(f"{pad}{_dump_key(k)}:")
                    emit(v, indent + 2)
                else:
                    raise ValueError(f"empty map at {k!r}")
            elif isinstance(v, (list, tuple)):
                if any(isinstance(x, (Mapping, list, tuple)) for x in v):
                    raise ValueError(f"nested list at {k!r}")
                out.append(f"{pad}{_dump_key(k)}: ["
                           + ", ".join(_dump_item(x) for x in v) + "]")
            else:
                out.append(f"{pad}{_dump_key(k)}: {_dump_scalar(v)}")

    if not isinstance(obj, Mapping):
        raise ValueError("save_config writes a map")
    emit(obj, 0)
    return "\n".join(out) + "\n"
