"""The architecture configs (port of `repro.configs`): the decoder
families and whisper-base's encoder-decoder.

Each module exposes CONFIG (full size), selectable with `--arch <id>` in
the launcher; `get(name)` returns the full config, `get_smoke(name)` the
reduced same-family config of the CPU tests."""

from __future__ import annotations

import importlib

ARCHS = (
    "phi4_mini_3_8b",
    "mistral_large_123b",
    "qwen3_8b",
    "nemotron_4_15b",
    "whisper_base",
    "mamba2_130m",
    "zamba2_2_7b",
    "llama4_maverick_400b_a17b",
    "olmoe_1b_7b",
    "llama_3_2_vision_90b",
)

# accept dashed ids too
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    name = name.replace(".", "_")
    return ALIASES.get(name, name)


def get(name: str):
    name = canonical(name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (have: {', '.join(ARCHS)})")
    return importlib.import_module(f".{name}", __package__).CONFIG


def get_smoke(name: str):
    from ..models import smoke_config

    return smoke_config(get(name))


def all_configs():
    return {a: get(a) for a in ARCHS}
