"""Config loading: a YAML root whose group entries name per-group YAML
files, CLI flags generated from the config's annotations, and the
``@with_config`` script decorator.

Counterpart of ``pdm_tpu/config/loader.py`` (``flatten_config``,
``parse_args_from_config``, ``update_config_from_args``,
``_materialize_group_paths``, ``load_config``, ``with_config``). Every leaf
becomes a ``--group.field`` flag, booleans get ``--no-`` variants. The YAML
files are the port's own copies under ``config/yaml/`` (byte for byte the
JAX package's), read by :mod:`.yaml_subset`, since PyYAML is not a
dependency of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import types
import typing
from functools import wraps
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from . import yaml_subset
from .config import Config, field_types

DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "yaml", "config.yaml"
)


def _is_group(value: Any) -> bool:
    return dataclasses.is_dataclass(value) and not isinstance(value, type)


def flatten_config(config: Any, parent_key: str = "") -> Dict[str, Any]:
    """{"group.field": value} over the config tree."""
    items = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        key = f"{parent_key}.{f.name}" if parent_key else f.name
        if _is_group(v):
            items.update(flatten_config(v, key))
        else:
            items[key] = v
    return items


def _flatten_with_annotations(config: Any, parent_key: str = ""
                              ) -> Iterator[Tuple[str, Any, Any]]:
    """(key, value, declared annotation) triples over the config tree: the
    annotation types the CLI flag, so an Optional[int] field that is None
    still parses as int, and list fields parse as YAML."""
    for name, annotation in field_types(type(config)).items():
        v = getattr(config, name)
        key = f"{parent_key}.{name}" if parent_key else name
        if _is_group(v):
            yield from _flatten_with_annotations(v, key)
        else:
            yield key, v, annotation


def _cli_kind(annotation: Any) -> Any:
    """'bool', a scalar type, or 'yaml' (the flag is parsed as YAML).

    Optional[X] and ``X | None`` map to X's kind, Literal[...] of one
    scalar type to that type (YAML would turn the strings 'no' and 'on'
    into booleans)."""
    origin = typing.get_origin(annotation)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return _cli_kind(args[0])
        return "yaml"
    if origin is typing.Literal:
        value_types = {type(v) for v in typing.get_args(annotation)}
        if value_types == {str}:
            return str
        if len(value_types) == 1:
            return _cli_kind(value_types.pop())
        return "yaml"
    if annotation is bool:
        return "bool"
    if annotation in (int, float, str):
        return annotation
    return "yaml"


def parse_args_from_config(
    config: Config, argv: Optional[list] = None
) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    for key, _value, annotation in _flatten_with_annotations(config):
        kind = _cli_kind(annotation)
        if kind == "bool":
            parser.add_argument(f"--{key}", action="store_true", default=None)
            parser.add_argument(
                f"--no-{key}", dest=key, action="store_false", default=None
            )
        elif kind == "yaml":
            parser.add_argument(
                f"--{key}", type=yaml_subset.safe_load, default=None
            )
        else:
            parser.add_argument(f"--{key}", type=kind, default=None)
    return parser.parse_args(argv)


def update_config_from_args(config: Config, args: argparse.Namespace) -> None:
    for arg_key, arg_value in vars(args).items():
        if arg_value is None:
            continue
        *heads, leaf = arg_key.split(".")
        sub = config
        for head in heads:
            sub = getattr(sub, head)
        setattr(sub, leaf, arg_value)


def _materialize_group_paths(root: dict, base_dir: str) -> dict:
    """Top-level string values ending in .yaml are per-group config files;
    load them in place."""
    out: Dict[str, Any] = {}
    for key, val in root.items():
        if isinstance(val, str) and val.endswith((".yml", ".yaml")):
            path = val if os.path.isabs(val) else os.path.join(base_dir, val)
            out[key] = yaml_subset.load_file(path)
        else:
            out[key] = val
    return out


def load_config(config_path: Optional[str] = None) -> Config:
    """The config at ``config_path``, else ``$PDM_CONFIG``, else the
    default ``config.yaml``."""
    path = config_path or os.environ.get("PDM_CONFIG", DEFAULT_CONFIG_PATH)
    root = yaml_subset.load_file(path)
    root = _materialize_group_paths(root, os.path.dirname(os.path.abspath(path)))
    return Config(**root)


def with_config(
    config_path: Optional[str] = None, *, parse_args: bool = False
) -> Callable:
    """Decorator injecting a loaded (and CLI-overridden) Config as the
    first argument of ``main``. The wrapped function parses ``sys.argv``
    when ``parse_args`` is true, or the list it is given as ``argv=``.
    Whenever it parses arguments, a ``--device`` flag (the card when
    absent, ``cpu`` for the plain versions) is taken out of them first and
    passed to ``main`` as ``device=``."""

    def decorator(func: Callable) -> Callable:
        @wraps(func)
        def wrapper(*args, argv: Optional[list] = None, **kwargs):
            config = load_config(config_path)
            if parse_args or argv is not None:
                argv = sys.argv[1:] if argv is None else list(argv)
                flag = argparse.ArgumentParser(add_help=False)
                flag.add_argument("--device", default=None)
                known, argv = flag.parse_known_args(argv)
                kwargs.setdefault("device", known.device)
                update_config_from_args(config,
                                        parse_args_from_config(config, argv))
            return func(config, *args, **kwargs)

        return wrapper

    return decorator
