"""Dataclass-driven CLI argument parsing (the port's own copy of
``huggingface_asr_tpu/utils/argparsing.py``).

The reference parses grouped dataclasses with HfArgumentParser (reference:
src/utilities/training_arguments.py:10-281 + every entry point). This is a
dependency-free equivalent: each dataclass field becomes ``--field_name``;
bools become ``--flag`` / ``--no-flag``; Optional/tuple/list types are
inferred from annotations; a ``--config_json`` file can prefill any group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, List, Optional, Sequence, Tuple, Type


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _add_field(parser: argparse.ArgumentParser, field: dataclasses.Field, tp):
    tp, _ = _unwrap_optional(tp)
    name = f"--{field.name}"
    default = (
        field.default
        if field.default is not dataclasses.MISSING
        else (field.default_factory() if field.default_factory is not dataclasses.MISSING else None)
    )
    origin = typing.get_origin(tp)
    if tp is bool:
        group = parser.add_mutually_exclusive_group()
        group.add_argument(name, dest=field.name, action="store_true", default=default)
        group.add_argument(
            f"--no-{field.name}", dest=field.name, action="store_false"
        )
    elif origin in (list, tuple) or tp in (list, tuple):
        inner = (typing.get_args(tp) or (str,))[0]
        if inner is Ellipsis:
            inner = str
        parser.add_argument(name, nargs="*", type=inner, default=default)
    else:
        if not callable(tp) or isinstance(tp, str):
            tp = str
        parser.add_argument(name, type=tp, default=default)


class DataclassArgumentParser:
    """Parse argv into instances of the given dataclass types."""

    def __init__(self, dataclass_types: Sequence[Type]):
        self.dataclass_types = list(dataclass_types)
        self.parser = argparse.ArgumentParser(allow_abbrev=False)
        self.parser.add_argument("--config_json", type=str, default=None)
        seen = set()
        self._hints = {}
        for dc in self.dataclass_types:
            # Resolve string annotations (PEP 563) to real types.
            hints = typing.get_type_hints(dc)
            self._hints[dc] = hints
            for field in dataclasses.fields(dc):
                if field.name in seen:
                    continue  # shared field name: first group wins, value shared
                seen.add(field.name)
                _add_field(self.parser, field, hints[field.name])

    def parse_args_into_dataclasses(self, args: Optional[List[str]] = None) -> Tuple:
        ns, extra = self.parser.parse_known_args(args)
        if extra:
            raise SystemExit(f"unknown arguments: {extra}")
        values = vars(ns)
        if values.get("config_json"):
            with open(values["config_json"]) as f:
                overrides = json.load(f)
            for k, v in overrides.items():
                if values.get(k) == self.parser.get_default(k):
                    values[k] = v
        out = []
        for dc in self.dataclass_types:
            names = {f.name for f in dataclasses.fields(dc)}
            kwargs = {}
            for k in names:
                v = values.get(k)
                tp, _ = _unwrap_optional(self._hints[dc][k])
                if typing.get_origin(tp) is tuple and isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            out.append(dc(**kwargs))
        return tuple(out)


def parse_override_string(update_str: str, obj: Any) -> Any:
    """Apply "key=value;key2=value2" overrides to a dataclass instance
    (reference GenerationConfigCustom.update_from_string, decoding/config.py:25-61)."""
    updates = {}
    for pair in update_str.split(";"):
        if not pair:
            continue
        k, v = pair.split("=", 1)
        if not hasattr(obj, k):
            raise ValueError(f"key {k} isn't in {type(obj).__name__}")
        old = getattr(obj, k)
        if isinstance(old, bool):
            v = v.lower() in ("true", "1", "y", "yes")
        elif isinstance(old, int):
            v = int(v)
        elif isinstance(old, float):
            v = float(v)
        updates[k] = v
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **updates)
    for k, v in updates.items():
        setattr(obj, k, v)
    return obj


def split_prefixed_overrides(kwargs: dict) -> Tuple[dict, dict, dict]:
    """Route "encoder_*"/"decoder_*" prefixed keys to sub-configs
    (reference model_utils.py:68-114 fetch_config)."""
    enc, dec, rest = {}, {}, {}
    for k, v in kwargs.items():
        if k.startswith("encoder_"):
            enc[k[len("encoder_"):]] = v
        elif k.startswith("decoder_") and k != "decoder_start_token_id":
            dec[k[len("decoder_"):]] = v
        else:
            rest[k] = v
    return enc, dec, rest
