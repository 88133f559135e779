"""Config I/O: YAML files to and from attribute namespaces
(cyclegan_tpu/config.py ``Namespace``, ``yaml2namespace`` and
``namespace2yaml``).

PyYAML is not a dependency of the port, so this module reads the subset
of YAML the repo's configs use: nested block mappings, block lists (at or
below their key's indentation), flow lists ``[a, b]``, plain and quoted
scalars resolved as PyYAML's safe loader resolves them (null, bool, int,
float, string), and ``#`` comments. Anything else raises ``ValueError``.
It writes the same subset, which PyYAML's safe loader reads back to the
same values.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple


class Namespace(dict):
    """A dict with attribute access, recursively applied to nested dicts.

    Missing keys raise ``KeyError`` from item access and ``AttributeError``
    from attribute access.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as exc:  # AttributeError expected by hasattr()
            raise AttributeError(name) from exc
        if isinstance(value, dict) and not isinstance(value, Namespace):
            value = Namespace(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def to_dict(self) -> Dict[str, Any]:
        def convert(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: convert(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [convert(v) for v in value]
            return value

        return convert(self)


# PyYAML's implicit resolvers (yaml/resolver.py), decimal forms only.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.replace("_", "").lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(low)
    if text[:1] in "[]{}&*!|>%@`":
        raise ValueError(f"YAML construct not supported: {text!r}")
    return text


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list: {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        if "[" in inner or "{" in inner:
            raise ValueError(f"nested flow collections not supported: "
                             f"{text!r}")
        return [_scalar(part.strip()) for part in inner.split(",")]
    if text == "{}":
        return {}
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2  # '' is a quote inside a single-quoted scalar
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _split_key(text: str) -> Tuple[str, str]:
    m = re.match(r"^('[^']*'|\"[^\"]*\"|[^'\"][^:]*?)\s*:(?:\s+(.*))?$", text)
    if m is None:
        raise ValueError(f"expected 'key: value', got {text!r}")
    key = _scalar(m.group(1))
    return key, (m.group(2) or "").strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[Tuple[int, str]], i: int, indent: int):
    if _is_item(lines[i][1]):
        return _list(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines, i, indent, in_mapping):
    """The block value of a key or item with nothing after it, if any."""
    if i < len(lines):
        nxt_indent, nxt = lines[i]
        if nxt_indent > indent or (in_mapping and nxt_indent == indent
                                   and _is_item(nxt)):
            return _block(lines, i, nxt_indent)
    return None, i


def _mapping(lines, i, indent):
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        if _is_item(lines[i][1]):
            raise ValueError(f"list item where a key was expected: "
                             f"{lines[i][1]!r}")
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest:
            out[key] = _value(rest)
        else:
            out[key], i = _nested(lines, i, indent, in_mapping=True)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def _list(lines, i, indent):
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].strip()
        if not rest:
            value, i = _nested(lines, i + 1, indent, in_mapping=False)
        elif not rest.startswith(("[", "'", '"')) and re.search(
                r":(\s|$)", rest):
            # "- key: value" opens a mapping indented past the dash
            inner = indent + len(lines[i][1]) - len(rest)
            lines[i] = (inner, rest)
            value, i = _mapping(lines, i, inner)
        else:
            value, i = _value(rest), i + 1
        out.append(value)
    return out, i


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation is not YAML")
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"could not parse from {lines[i][1]!r}")
    return value


def yaml2namespace(yaml_path) -> Namespace:
    """Load a YAML file into a Namespace."""
    with open(yaml_path, "r") as f:
        return Namespace(parse_yaml(f.read()))


_PLAIN = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./ -]*$")


def _emit_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        # PyYAML's representer: a float without a dot gets one before the
        # exponent, since 1e-07 alone resolves to a string
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _PLAIN.match(value) and value == value.strip() and \
                _scalar(value) == value:
            return value
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _emit(value: Any, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_emit_scalar(str(key))}:"
            if isinstance(item, dict) and item:
                lines.append(head)
                _emit(item, indent + 2, lines)
            elif isinstance(item, (list, tuple)) and item:
                lines.append(head)
                _emit(list(item), indent + 2, lines)
            else:
                lines.append(f"{head} {_emit_inline(item)}")
    else:
        for item in value:
            if isinstance(item, (dict, list, tuple)) and item:
                raise TypeError(f"cannot write a nested collection in a "
                                f"list as YAML: {item!r}")
            lines.append(f"{pad}- {_emit_inline(item)}")


def _emit_inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _emit_scalar(value)


def dump_yaml(data: Any) -> str:
    """A mapping of scalars, mappings and lists of scalars as block YAML."""
    if not isinstance(data, dict):
        raise TypeError("the top level of a config is a mapping")
    lines: List[str] = []
    _emit(data, 0, lines)
    return "\n".join(lines) + "\n"


def namespace2yaml(yaml_path, namespace: Namespace) -> None:
    """Write a Namespace (or dict) to a YAML file that ``yaml2namespace``
    (and PyYAML) read back to the same values."""
    data = namespace.to_dict() if isinstance(namespace, Namespace) else \
        Namespace(namespace).to_dict()
    with open(yaml_path, "w") as f:
        f.write(dump_yaml(data))
