"""Dataclass-backed CLI configs.

A copy of ``world_modelz_tpu.utils.config`` (the port imports nothing of
the JAX package): dataclass fields become CLI flags; tuple fields accept
the reference's comma-string syntax (``--extents 3,1,1``) and bools accept
yes/no/true/false/0/1. Configs serialize to dicts for embedding into
checkpoints and back.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def str2bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}")


def _parser_for(field: dataclasses.Field):
    t = field.type
    origin = get_origin(t)
    if t in (bool, "bool"):
        return str2bool
    if origin in (tuple, Tuple) or (isinstance(t, str) and "Tuple" in t):
        args = get_args(t)
        elem = args[0] if args else int
        if elem is Ellipsis:
            elem = int

        def parse_tuple(s: str, elem=elem):
            if isinstance(s, (tuple, list)):
                return tuple(s)
            return tuple(elem(x) for x in str(s).split(","))

        return parse_tuple
    if t in (int, float, str, "int", "float", "str"):
        return {"int": int, "float": float, "str": str}.get(t, t)
    if origin is type(Optional[int]) or str(t).startswith("typing.Optional"):
        inner = get_args(t)[0]

        def parse_opt(s, inner=inner):
            if s is None or str(s).lower() in ("none", ""):
                return None
            return inner(s)

        return parse_opt
    return str


def dataclass_cli(
    cls: Type[T],
    argv: Optional[Sequence[str]] = None,
    description: Optional[str] = None,
) -> T:
    """Build an argparse CLI from dataclass `cls` and parse `argv`."""
    parser = argparse.ArgumentParser(description=description or cls.__doc__)
    for field in dataclasses.fields(cls):
        if not field.init:
            continue
        default = (
            field.default
            if field.default is not dataclasses.MISSING
            else (
                field.default_factory()
                if field.default_factory is not dataclasses.MISSING
                else None
            )
        )
        parser.add_argument(
            f"--{field.name}",
            type=_parser_for(field),
            default=default,
            help=field.metadata.get("help", ""),
        )
    ns = parser.parse_args(argv)
    return cls(**vars(ns))


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    return {
        k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()
    }


def config_from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    """A ``cls`` from a config dict (as embedded in a checkpoint): keys
    that are not fields of ``cls`` are dropped, lists become tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in names})


def unported(what: str, item: str) -> NotImplementedError:
    """The error a CLI raises for an option whose feature is not ported."""
    return NotImplementedError(
        f"{what} is not ported to world_modelz_tpu_torch yet (ROADMAP {item})")


def check_defaults(cfg: Any, fields: Dict[str, Tuple[str, str]]) -> None:
    """Raise ``unported`` for a field of ``fields`` (name -> (what reads
    it, ROADMAP item)) set to anything but its default: flags kept only for
    parity with the JAX CLI, which nothing in the port reads."""
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    for name, (what, item) in fields.items():
        if getattr(cfg, name) != defaults[name]:
            raise unported(f"--{name} ({what})", item)
