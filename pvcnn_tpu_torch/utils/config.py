"""Executable-Python configs (counterpart of pvcnn_tpu/utils/config.py).

The reference's way of configuring a run: python config files that layer
mutations onto a global `configs` singleton, chained through the
`__init__.py` of every directory on a file's path, dotted command-line
overrides, and late-binding factory nodes. A `Config` node holds a factory
and keyword children and builds the object tree when called. Config
*files* are executed, not imported.

The chain starts at the last directory named `configs` on the path, so
`pvcnn_tpu_torch/configs/shapenet/pvcnn/c1.py` runs configs/__init__.py,
configs/shapenet/__init__.py, configs/shapenet/pvcnn/__init__.py and c1.py,
and never the package's own `__init__.py`. A path with no `configs`
directory chains through every prefix, as the JAX loader does.

Usage:
    configs.update_from_file('pvcnn_tpu_torch/configs/shapenet/pvcnn/c1.py')
    configs.update_from_arguments('--configs.train.num_epochs=1')
    model = configs.model()           # instantiates the factory tree
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["Config", "configs"]


class AttrDict(dict):
    def __getattr__(self, k):
        if k not in self:
            raise AttributeError(k)
        return self[k]

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        del self[k]


class Config(AttrDict):
    """A dict node that can also act as a late-binding factory.

    `Config(fn, key=value, ...)` stores `fn`; calling the node instantiates it
    with its children as keyword arguments (children that are themselves
    non-detached Config factories are instantiated first, recursively), and
    the call's own arguments after them. `detach=True` passes the child
    Config through un-instantiated."""

    def __init__(self, _func_=None, _detach_: bool = False, **kwargs):
        super().__init__(**kwargs)
        if _func_ is not None and not callable(_func_):
            raise TypeError(f"func {_func_!r} is not callable")
        self.__dict__["_func_"] = _func_
        self.__dict__["_detach_"] = _detach_

    @property
    def func(self):
        return self.__dict__.get("_func_")

    @property
    def detached(self):
        return self.__dict__.get("_detach_", False)

    def __call__(self, *args, **kwargs):
        if self.func is None:
            return self
        built = {k: _build(v) for k, v in self.items()}
        built.update(kwargs)
        return self.func(*args, **built)

    # ---- file / CLI loading -------------------------------------------------

    def update_from_file(self, path: str):
        """Execute the `__init__.py` of every directory from the last one
        named `configs` down to `path`'s own (every prefix where there is
        none), then `path`; each file once."""
        executed = set()

        def exec_once(p):
            p = os.path.normpath(p)
            if p in executed or not os.path.exists(p):
                return
            executed.add(p)
            with open(p) as f:
                code = compile(f.read(), p, "exec")
            exec(code, {"__file__": p, "__name__": "__config__"})

        path = os.path.normpath(path)
        parts = path.split(os.sep)
        dirs = parts[:-1]
        first = (len(dirs) - dirs[::-1].index("configs")
                 if "configs" in dirs else 1)
        for i in range(first, len(parts)):
            prefix = os.sep.join(parts[:i])  # preserves a leading '/'
            if prefix:
                exec_once(os.path.join(prefix, "__init__.py"))
        exec_once(path)

    def update_from_modules(self, *paths: str):
        for p in paths:
            self.update_from_file(p)

    def update_from_arguments(self, *args: str):
        index = 0
        args = list(args)
        while index < len(args):
            arg = args[index]
            if not arg.startswith("--configs."):
                raise ValueError(f'unrecognized argument "{arg}"')
            arg = arg[len("--configs."):]
            if "=" in arg:
                dotted, val = arg.split("=", 1)
                index += 1
            else:
                dotted, val = arg, args[index + 1]
                index += 2
            node = self
            keys = dotted.split(".")
            for k in keys[:-1]:
                if k not in node or not isinstance(node[k], Config):
                    node[k] = Config()
                node = node[k]
            node[keys[-1]] = _parse_value(val)

    # ---- display ------------------------------------------------------------

    def __str__(self, indent: int = 0) -> str:
        lines = []
        if self.func is not None:
            lines.append(" " * indent + f"[func] = {self.func}")
        for k, v in self.items():
            if isinstance(v, Config):
                lines.append(" " * indent + f"[{k}]")
                sub = v.__str__(indent + 2)
                if sub:
                    lines.append(sub)
            else:
                lines.append(" " * indent + f"[{k}] = {v}")
        return "\n".join(lines)


def _build(v: Any):
    if isinstance(v, Config):
        return v if v.detached else v()
    if isinstance(v, (list, tuple)):
        return type(v)(_build(x) for x in v)
    return v


def _parse_value(x: str):
    """An override's value: a quoted string without its quotes, else the
    value of a Python expression of literals (numbers, tuples, lists,
    True, None, arithmetic), else the text itself. Names resolve to
    nothing, builtins included, so `iter` stays the string 'iter' (the
    JAX package's eval(x, {}, {}) makes it the builtin function, and
    --configs.train.scheduler_unit=iter then selects no per-step
    schedule)."""
    if len(x) >= 2 and x[0] == x[-1] and x[0] in "'\"":
        return x[1:-1]
    try:
        return eval(x, {"__builtins__": {}}, {})
    except Exception:
        return x


configs = Config()
