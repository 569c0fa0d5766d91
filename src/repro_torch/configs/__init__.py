"""Architecture configs ported so far (the dense ones the serve launcher
runs); `get(name)` returns the full-size config."""

from __future__ import annotations

import importlib

ARCHS = ("phi4_mini_3_8b",)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    name = name.replace(".", "_")
    return ALIASES.get(name, name)


def get(name: str):
    name = canonical(name)
    if name not in ARCHS:
        raise NotImplementedError(f"arch {name!r}: not ported yet "
                                  f"(ported: {', '.join(ARCHS)})")
    return importlib.import_module(f".{name}", __package__).CONFIG
