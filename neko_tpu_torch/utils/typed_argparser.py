"""Dataclass -> argparse bridge (counterpart of
neko_tpu/utils/typed_argparser.py).

Literal -> choices, bool -> `--x [true|false]` with a `--no_x` complement,
List -> nargs='+', Optional unwrapping, metadata help / aliases, `.args`
files inlined before the command line, and parsing into dataclass
instances or from a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
from typing import Any, Dict, List, Literal, Union, get_args, get_origin


def string_to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"truthy value expected, got {v!r}")


class TypedArgumentParser(argparse.ArgumentParser):
    def __init__(self, dataclass_types, **kwargs):
        kwargs.setdefault("formatter_class", argparse.ArgumentDefaultsHelpFormatter)
        super().__init__(**kwargs)
        if dataclasses.is_dataclass(dataclass_types):
            dataclass_types = [dataclass_types]
        self.dataclass_types = list(dataclass_types)
        for dtype in self.dataclass_types:
            hints = typing.get_type_hints(dtype)  # resolves string annotations
            for f in dataclasses.fields(dtype):
                if f.init:
                    self._add_field(f, hints.get(f.name, f.type))

    def _add_field(self, f: dataclasses.Field, ftype) -> None:
        name = f"--{f.name}"
        aliases = list(f.metadata.get("aliases", []))
        kwargs: Dict[str, Any] = {}
        if "help" in f.metadata:
            kwargs["help"] = f.metadata["help"]
        origin = get_origin(ftype)
        if origin is Union:  # Optional[X] -> X, None allowed as the default
            args = [a for a in get_args(ftype) if a is not type(None)]
            if len(args) != 1:
                raise TypeError(f"unsupported Union field {f.name}: {ftype}")
            ftype = args[0]
            origin = get_origin(ftype)
        if f.default_factory is not dataclasses.MISSING:
            kwargs["default"] = f.default_factory()
        elif f.default is not dataclasses.MISSING:
            kwargs["default"] = f.default
        else:
            kwargs["required"] = True

        if origin is Literal:
            choices = list(get_args(ftype))
            kwargs.update(choices=choices, type=type(choices[0]))
        elif ftype is bool:
            kwargs.update(type=string_to_bool, nargs="?", const=True)
        elif origin in (list, List):
            (elem,) = get_args(ftype) or (str,)
            kwargs.update(nargs=f.metadata.get("nargs", "+"), type=elem)
        else:
            kwargs["type"] = ftype
        self.add_argument(name, *aliases, **kwargs)
        if ftype is bool:  # after --x: the first action of a dest sets its default
            self.add_argument(f"--no_{f.name}", action="store_false", dest=f.name,
                              help=argparse.SUPPRESS)

    def parse_args_into_dataclasses(self, args=None, return_remaining_strings: bool = False):
        namespace, remaining = self.parse_known_args(self._expand_args_files(args))
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            outputs.append(dtype(**{k: v for k, v in vars(namespace).items() if k in keys}))
        if return_remaining_strings:
            return (*outputs, remaining)
        if remaining:
            raise ValueError(f"Unrecognized arguments: {remaining}")
        return tuple(outputs)

    @staticmethod
    def _expand_args_files(args):
        """Inline the contents of `.args` files given on the command line;
        they come first, so explicit flags override them."""
        if args is None:
            args = sys.argv[1:]
        file_args: list = []
        rest: list = []
        for a in args:
            if isinstance(a, str) and a.endswith(".args"):
                with open(a) as fh:
                    file_args += fh.read().split()
            else:
                rest.append(a)
        return file_args + rest

    def parse_dict(self, data: Dict[str, Any], allow_extra_keys: bool = True):
        outputs = []
        for dtype in self.dataclass_types:
            keys = {f.name for f in dataclasses.fields(dtype) if f.init}
            unknown = set(data) - keys
            if unknown and not allow_extra_keys:
                raise ValueError(f"Unknown keys: {sorted(unknown)}")
            outputs.append(dtype(**{k: v for k, v in data.items() if k in keys}))
        return tuple(outputs)
