"""YAML-config -> argparse reflection (counterpart of
``audio_only_speech_separation_tpu/utils/parser_utils.py``, which the port
cannot import: that package's ``utils/__init__.py`` imports JAX).

Behavioral contract (reference: look2hear/utils/parser_utils.py:11-155):
every leaf of a two-level config dict becomes a ``--flag`` with a type
inferred from its default value (None → str-or-int-or-float, bool-ish →
bool), and the parsed namespace is reassembled into a nested dict keyed by
the original top-level group names, with ungrouped args under ``main_args``.

"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional


def str_int_float(value: str):
    """Cast ``value`` to int, then float, else leave as str."""
    if _isint(value):
        return int(value)
    if _isfloat(value):
        return float(value)
    return value


def str2bool(value):
    """Convert boolean-looking strings to bool; return input otherwise."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low in ("yes", "true", "y", "1"):
        return True
    if low in ("no", "false", "n", "0"):
        return False
    return value


def str2bool_arg(value):
    value = str2bool(value)
    if isinstance(value, bool):
        return value
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {value!r}")


def _isint(v) -> bool:
    try:
        int(v)
        return True
    except (TypeError, ValueError):
        return False


def _isfloat(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _entry_type(default: Any):
    """Infer an argparse type callable from a default value."""
    if default is None:
        return str_int_float
    if isinstance(str2bool(default), bool):
        return str2bool_arg
    return type(default)


def prepare_parser_from_dict(
    dic: Dict[str, Any], parser: Optional[argparse.ArgumentParser] = None
) -> argparse.ArgumentParser:
    """Build a parser with one argument group per top-level config key.

    Second-level keys become ``--<leaf>`` flags whose defaults are the YAML
    values; list/str top-level values become ``--<key>`` directly.  Deeper
    nesting (e.g. ``audionet_config``) stays as a dict default, overridable
    only through YAML — matching the reference semantics.
    """
    if parser is None:
        parser = argparse.ArgumentParser()
    for key, val in dic.items():
        group = parser.add_argument_group(key)
        if isinstance(val, dict):
            for leaf, leaf_val in val.items():
                if isinstance(leaf_val, dict):
                    # nested dicts stay opaque; default passthrough
                    group.add_argument(f"--{leaf}", default=leaf_val, type=_DictArg(leaf_val))
                else:
                    group.add_argument(f"--{leaf}", default=leaf_val, type=_entry_type(leaf_val))
        elif isinstance(val, (list, str)):
            group.add_argument(f"--{key}", default=val, type=_entry_type(val))
    return parser


class _DictArg:
    """Type callable for dict-valued flags: accepts YAML/py-literal strings."""

    def __init__(self, default):
        self.default = default

    def __call__(self, value):
        if isinstance(value, dict):
            return value
        import ast

        try:
            parsed = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            import yaml

            parsed = yaml.safe_load(value)
        if not isinstance(parsed, dict):
            raise argparse.ArgumentTypeError(f"expected a dict literal, got {value!r}")
        return parsed


def parse_args_as_dict(parser: argparse.ArgumentParser, args=None) -> Dict[str, Any]:
    """Parse and reassemble the nested {group: {leaf: value}} dict.

    Ungrouped arguments (added before `prepare_parser_from_dict`) land under
    ``main_args`` (reference: parser_utils.py:149-152).
    """
    namespace = parser.parse_args(args=args)
    out: Dict[str, Any] = {}
    for group in parser._action_groups:  # argparse offers no public group API
        group_dict = {
            a.dest: getattr(namespace, a.dest, None) for a in group._group_actions
        }
        out[group.title] = group_dict
    # argparse names its default group differently across versions
    for default_title in ("optional arguments", "options"):
        if default_title in out:
            out["main_args"] = out.pop(default_title)
            break
    out.setdefault("main_args", {})
    out.pop("positional arguments", None)
    return out


def split_dotted_overrides(argv):
    """Pull ``--group.leaf value`` and ``--group.leaf=value`` out of
    ``argv``: returns ({(group, leaf): value}, the other arguments).  They
    set ``config[group][leaf]`` whether or not the YAML file has that leaf
    (``--training.precision bfloat16``); values are typed as bools, ints,
    floats or strings."""
    overrides, rest, i = {}, [], 0
    while i < len(argv):
        arg = argv[i]
        name = arg[2:].split("=", 1)[0] if arg.startswith("--") else ""
        if "." not in name:
            rest.append(arg)
            i += 1
            continue
        if "=" in arg:
            value = arg.split("=", 1)[1]
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"{arg} needs a value")
            value, i = argv[i + 1], i + 2
        group, leaf = name.split(".", 1)
        typed = str2bool(value)
        overrides[(group, leaf)] = typed if isinstance(typed, bool) else str_int_float(typed)
    return overrides, rest
