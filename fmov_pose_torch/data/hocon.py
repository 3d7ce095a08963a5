"""HOCON conf reader of the port (counterpart of
``fmov_pose_tpu/data/hocon.py``), so the port reads ``confs/*.conf``
without the JAX package on the path.

It parses the subset of HOCON those files use: nested ``name { ... }``
sections, ``key = value`` and ``key: value``, quoted keys, numbers
(``5e-4`` too), ``True``/``False``, unquoted strings and paths, lists over
one or more lines, trailing commas, and ``#`` / ``//`` comments.  The tree
it returns has the pyhocon accessors the runner uses: ``get``,
``get_int``, ``get_float``, ``get_bool``, ``get_string``, ``get_list``,
``put``, dotted-path ``[]`` and ``in``, and ``as_plain_dict``.
``tests/test_torch_runner.py`` holds it against the JAX package's parser
on every conf of the repo.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["ConfigTree", "parse_string", "parse_file"]

_MISSING = object()
_KEY = r'("(?:[^"]*)"|[\w.\-/]+)'
_KEY_VALUE_RE = re.compile(_KEY + r"\s*([={:])\s*(.*)$")
_BARE_KEY_RE = re.compile(_KEY + r"\s*$")
_NEXT_PAIR_RE = re.compile(r"^(.*?),\s*(" + _KEY + r"\s*[=:{].*)$")
_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_INT_RE = re.compile(r"^[+-]?\d+$")


class ConfigTree(dict):
    """A dict with pyhocon's dotted-path access."""

    def _resolve(self, path: str, default=_MISSING):
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and dict.__contains__(node, part):
                node = dict.__getitem__(node, part)
            elif default is _MISSING:
                raise KeyError(path)
            else:
                return default
        return node

    def __getitem__(self, path):
        if isinstance(path, str) and "." in path:
            return self._resolve(path)
        return dict.__getitem__(self, path)

    def __contains__(self, path):
        try:
            self._resolve(path)
            return True
        except (KeyError, TypeError, AttributeError):
            return False

    def get(self, path, default=None):
        return self._resolve(path, default)

    def _typed(self, path, default, cast):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        return cast(v)

    def get_int(self, path, default=_MISSING):
        return self._typed(path, default, int)

    def get_float(self, path, default=_MISSING):
        return self._typed(path, default, float)

    def get_bool(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if isinstance(v, str):
            return v.strip().lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_string(self, path, default=_MISSING):
        v = self._resolve(path, default)
        return v if v is None else str(v)

    def get_list(self, path, default=_MISSING):
        return self._resolve(path, default)

    def put(self, path: str, value):
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            nxt = dict.get(node, part)
            if not isinstance(nxt, ConfigTree):
                nxt = ConfigTree()
                dict.__setitem__(node, part, nxt)
            node = nxt
        dict.__setitem__(node, parts[-1], value)

    def as_plain_dict(self):
        return {k: v.as_plain_dict() if isinstance(v, ConfigTree) else v
                for k, v in self.items()}


def _coerce(token: str):
    token = token.strip()
    if len(token) >= 2 and token[0] == token[-1] == '"':
        return token[1:-1]
    low = token.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    if _NUM_RE.match(token):
        return int(token) if _INT_RE.match(token) else float(token)
    return token


def _strip_comment(line: str) -> str:
    """The line up to a ``#`` or ``//`` outside double quotes."""
    in_str = False
    for i, ch in enumerate(line):
        if ch == '"':
            in_str = not in_str
        elif not in_str and (ch == "#" or line.startswith("//", i)):
            return line[:i]
    return line


def _parse_list(text: str):
    items = (s.strip() for s in text.strip()[1:-1].split(","))
    return [_coerce(t) for t in items if t]


def parse_string(text: str) -> ConfigTree:
    root = ConfigTree()
    stack = [root]
    pending_key = None    # a section name whose "{" comes on a later line
    pending_list = None   # (key, text so far) of a list over several lines

    def open_section(key):
        sub = ConfigTree()
        stack[-1].put(key, sub)
        stack.append(sub)

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if pending_list is not None:
            key, acc = pending_list[0], pending_list[1] + " " + line
            if "]" in line:
                stack[-1].put(key, _parse_list(acc))
                pending_list = None
            else:
                pending_list = (key, acc)
            continue

        while line:
            line = line.strip()
            if not line:
                break
            if line.startswith("}"):
                if len(stack) > 1:
                    stack.pop()
                line = line[1:]
                continue
            if pending_key is not None and line.startswith("{"):
                open_section(pending_key)
                pending_key = None
                line = line[1:]
                continue

            m = _KEY_VALUE_RE.match(line)
            if m is None:
                bare = _BARE_KEY_RE.match(line)
                if bare is None:
                    raise ValueError(f"cannot parse HOCON line: {raw!r}")
                pending_key = bare.group(1).strip('"')
                break
            key, sep, rest = m.group(1).strip('"'), m.group(2), m.group(3)
            if sep == "{":
                open_section(key)
                line = rest
                continue
            if rest.startswith("{"):
                open_section(key)
                line = rest[1:]
                continue
            if rest.startswith("["):
                if "]" in rest:
                    end = rest.rindex("]")
                    stack[-1].put(key, _parse_list(rest[:end + 1]))
                    line = rest[end + 1:].lstrip(", ")
                else:
                    pending_list = (key, rest)
                    line = ""
                continue
            # a scalar, perhaps followed by "}" or by another "key = value"
            trail = ""
            if "}" in rest:
                idx = rest.index("}")
                rest, trail = rest[:idx], rest[idx:]
            nxt = _NEXT_PAIR_RE.match(rest)
            if nxt:
                rest, trail = nxt.group(1), nxt.group(2) + trail
            stack[-1].put(key, _coerce(rest.strip().rstrip(",").strip()))
            line = trail
    return root


def parse_file(path: str, replacements=None) -> ConfigTree:
    """Parse ``path`` after replacing each key of ``replacements`` (such as
    ``CASE_NAME``) in its text with the value."""
    with open(path) as f:
        text = f.read()
    for k, v in (replacements or {}).items():
        text = text.replace(k, v)
    return parse_string(text)
