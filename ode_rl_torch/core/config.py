"""Layered configs from ``configs.yaml`` with typed command-line overrides.

Counterpart of ``ode_rl_tpu/core/config.py``: named blocks merge left to
right into an immutable ``Config`` (a mapping with attribute access), and
every resulting key becomes a typed ``--key value`` flag.

``configs.yaml`` is read by a small reader of its own, so the port needs
no YAML package. The file is flat: top-level blocks of ``key: scalar``
lines and flow lists of scalars, with ``#`` comments. The reader gives
what ``yaml.safe_load`` gives for such a file, YAML 1.1 rules included
(``True``/``yes``/``on`` are bools, ``1.0e-4`` is a float but a bare
``1e-4`` is a string), and raises on any line it does not understand:
nesting, block lists, anchors, tags, multi-line scalars, octal or
sexagesimal numbers.
"""

from __future__ import annotations

import argparse
import pathlib
import re
from typing import Any, Dict, Iterable, Mapping, Optional


class Config(Mapping):
    """Immutable attribute-accessible mapping."""

    def __init__(self, entries: Dict[str, Any]):
        object.__setattr__(self, "_entries", dict(entries))

    def __getitem__(self, key: str) -> Any:
        return self._entries[key]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._entries[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        raise AttributeError("Config is immutable; use .replace(**kw)")

    def replace(self, **kw: Any) -> "Config":
        entries = dict(self._entries)
        entries.update(kw)
        return Config(entries)

    def get(self, key: str, default: Any = None) -> Any:
        return self._entries.get(key, default)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self._entries == other._entries

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(self._entries.items()))
        return f"Config({body})"

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._entries)


# ----------------------------- the reader ----------------------------------

# YAML 1.1 implicit types (the resolvers of yaml.safe_load), decimal forms.
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)"
                    r"(?:[eE][-+][0-9]+)?$")
_INF_NAN = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            "+.inf": float("inf"), "+.Inf": float("inf"),
            "+.INF": float("inf"), "-.inf": float("-inf"),
            "-.Inf": float("-inf"), "-.INF": float("-inf"),
            ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
# Other YAML 1.1 number forms (binary, octal, hex, sexagesimal): refused.
_OTHER_NUMBER = re.compile(
    r"[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+"
    r"(?:\.[0-9_]*)?)$")
# Plain strings the reader accepts: no YAML indicator anywhere.
_PLAIN = re.compile(r"[A-Za-z0-9_./+][A-Za-z0-9_./+\- ]*$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


class YamlError(ValueError):
    pass


def _fail(lineno: int, line: str, why: str):
    raise YamlError(f"configs line {lineno}: {why}: {line.rstrip()!r}")


def _plain_scalar(text: str, lineno: int, line: str) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _INF_NAN:
        return _INF_NAN[text]
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OTHER_NUMBER.match(text):
        _fail(lineno, line, "number form not supported")
    if not _PLAIN.match(text):
        _fail(lineno, line, "not a flat scalar")
    return text


def _quoted(text: str, lineno: int, line: str):
    """A quoted scalar at the start of ``text``: (value, rest of text)."""
    q = text[0]
    if q == "'":
        i, out = 1, []
        while True:
            j = text.find("'", i)
            if j < 0:
                _fail(lineno, line, "unterminated quote")
            out.append(text[i:j])
            if text[j + 1:j + 2] == "'":       # '' is an escaped quote
                out.append("'")
                i = j + 2
                continue
            return "".join(out), text[j + 1:]
    j = text.find('"', 1)
    if j < 0:
        _fail(lineno, line, "unterminated quote")
    value = text[1:j]
    if "\\" in value:
        _fail(lineno, line, "escapes in double quotes not supported")
    return value, text[j + 1:]


def _check_rest(rest: str, lineno: int, line: str) -> None:
    """What follows a complete value must be blanks or a comment."""
    if rest.strip() and not re.match(r"\s+#", rest):
        _fail(lineno, line, "text after the value")


def _value(text: str, lineno: int, line: str) -> Any:
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, lineno, line)
        _check_rest(rest, lineno, line)
        return value
    if text[:1] == "[":
        close = text.find("]")
        if close < 0:
            _fail(lineno, line, "multi-line flow list")
        _check_rest(text[close + 1:], lineno, line)
        body = text[1:close]
        if "[" in body or "{" in body:
            _fail(lineno, line, "nested flow collection")
        items = [s.strip() for s in body.split(",")] if body.strip() else []
        out = []
        for item in items:
            if not item:
                _fail(lineno, line, "empty list item")
            if item[:1] in ("'", '"'):
                value, rest = _quoted(item, lineno, line)
                if rest.strip():
                    _fail(lineno, line, "text after a list item")
                out.append(value)
            else:
                out.append(_plain_scalar(item, lineno, line))
        return out
    plain = re.split(r"\s+#", text, maxsplit=1)[0].rstrip()
    if not plain:
        _fail(lineno, line, "a key without a scalar (nested block)")
    return _plain_scalar(plain, lineno, line)


def parse_config_blocks(text: str) -> Dict[str, Optional[Dict[str, Any]]]:
    """Parse a flat YAML file of named blocks of ``key: scalar`` lines."""
    blocks: Dict[str, Optional[Dict[str, Any]]] = {}
    block: Optional[str] = None
    indent: Optional[int] = None
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            _fail(lineno, line, "tab in indentation")
        lead = len(line) - len(line.lstrip(" "))
        key, sep, rest = stripped.partition(":")
        if not sep or not _KEY.match(key) or (rest and rest[0] != " "):
            _fail(lineno, line, "not a 'key: value' line")
        if lead == 0:
            if re.split(r"\s+#", rest, maxsplit=1)[0].strip():
                _fail(lineno, line, "a top-level key with a scalar")
            block, indent = key, None
            blocks[block] = None
            continue
        if block is None:
            _fail(lineno, line, "indented line outside a block")
        if indent is None:
            indent = lead
            blocks[block] = {}
        elif lead != indent:
            _fail(lineno, line, "nested or misaligned line")
        blocks[block][key] = _value(rest.strip(), lineno, line)
    return blocks


# ---------------------------- configuration --------------------------------

def coerce(default: Any, text: str) -> Any:
    """Coerce a CLI string to the type of ``default`` (bool from
    'True'/'False', an int promoted to float when the text has an 'e' or
    a '.', comma-separated tuples)."""
    if default is None:
        return text
    if isinstance(default, bool):
        if text not in ("True", "False", "true", "false", "1", "0"):
            raise argparse.ArgumentTypeError(f"expected bool, got {text!r}")
        return text in ("True", "true", "1")
    if isinstance(default, int):
        return float(text) if ("e" in text or "." in text) else int(text)
    if isinstance(default, float):
        return float(text)
    if isinstance(default, (list, tuple)):
        elem_default = default[0] if len(default) else ""
        return tuple(coerce(elem_default, y) for y in text.split(","))
    return type(default)(text)


def load_config(names: Iterable[str],
                config_path: Optional[pathlib.Path] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Merge named blocks left to right (from the repo's ``configs.yaml``
    by default), then apply overrides."""
    config_path = config_path or (
        pathlib.Path(__file__).resolve().parents[2] / "configs.yaml")
    blocks = parse_config_blocks(pathlib.Path(config_path).read_text())
    merged: Dict[str, Any] = {}
    for name in names:
        if name not in blocks:
            raise KeyError(
                f"no config block named {name!r} in {config_path} "
                f"(available: {sorted(blocks)})")
        merged.update(blocks[name] or {})
    for k, v in (overrides or {}).items():
        merged[k] = coerce(merged[k], v) if (
            k in merged and isinstance(v, str)) else v
    return Config(merged)


def add_cli_overrides(cfg_defaults: Dict[str, Any], argv) -> Dict[str, Any]:
    """Parse ``--key value`` overrides typed against the merged defaults."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    for key, value in sorted(cfg_defaults.items()):
        parser.add_argument(
            f"--{key}",
            type=lambda x, d=value: coerce(d, x) if isinstance(x, str) else x,
            default=value)
    return vars(parser.parse_args(argv))


def resolve_run_id(cfg: Config) -> str:
    """The experiment id: id plus the phase's in/out sequence lengths."""
    if cfg.get("phase", "train") == "train":
        return f"{cfg.id}_{cfg.train_in_seq}_{cfg.train_out_seq}"
    return f"{cfg.id}_{cfg.test_in_seq}_{cfg.test_out_seq}"
