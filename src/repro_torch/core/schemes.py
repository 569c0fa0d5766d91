"""Declarative scheme registry: schemes are data, not simulator code (a copy
of `repro.core.schemes` over the port's codec and layout registries).

A `Scheme` is a named record of behaviour flags + config parameters that
compiles to the engine's (flags, params) int32 vectors (engine.FLAG_* /
engine.PARAM_*).  The six paper schemes, ablations like `cram-nollp`
(CRAM with the LCT frozen — quantifies the predictor's value) and
config-axis variants like `cram@lct64` (Fig. 14-style LCT-size
sensitivity) are all registry entries; adding a variant never touches the
step function.

Registry API:
  get(name) / names() / resolve(name_or_scheme) / register(scheme)
  variant(base, **overrides)       — derive + register a new entry
  flags_matrix(schemes)            — (S, N_FLAGS) int32 for the engine
  params_matrix(schemes, cfg)      — (S, N_PARAMS) int32 for the engine
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..compression.codecs import get_codec
from ..compression.gate import COUNTER_INIT, COUNTER_MAX
from ..compression.layouts import get_layout
from ..compression.predictor import LCT_ENTRIES
from .engine import (
    FLAG_COMP,
    FLAG_DYNAMIC,
    FLAG_IDEAL,
    FLAG_LCT_UPDATE,
    FLAG_LLP,
    FLAG_META,
    FLAG_NEXTLINE,
    N_FLAGS,
    N_PARAMS,
    PARAM_COUNTER_INIT,
    PARAM_LCT_SIZE,
    PARAM_META_SETS,
    PARAM_SAMPLE_THRESH,
    SimConfig,
    sample_threshold,
)


@dataclass(frozen=True)
class Scheme:
    """One point in the simulator's design space.

    Behaviour flags mirror engine.FLAG_*; `lct_update=None` follows `llp`
    (the paper's schemes update the LCT iff they predict with it).  Config
    fields become the engine's traced params row: `sample_rate=None`
    defers to SimConfig.sample_rate at params_matrix time.

    `codec`/`layout` name the compression-registry entries the scheme's
    packability bits are defined against (repro.compression): the trace
    generator's pair/quad fit masks model the named codec packed into the
    named layout's states.  Both are validated against the registries.
    """
    name: str
    codec: str = "hybrid"
    layout: str = "group4"
    comp: bool = False
    llp: bool = False
    meta: bool = False
    nextline: bool = False
    ideal: bool = False
    dynamic: bool = False
    lct_update: bool | None = None
    lct_size: int = LCT_ENTRIES
    sample_rate: float | None = None
    counter_init: int = COUNTER_INIT
    meta_sets: int | None = None   # effective metadata-cache sets
    description: str = ""

    def __post_init__(self):
        get_codec(self.codec)        # raises on unknown registry names
        get_layout(self.layout)
        if not 1 <= self.lct_size <= LCT_ENTRIES:
            raise ValueError(
                f"lct_size must be in [1, {LCT_ENTRIES}], got {self.lct_size}")
        if not 0 <= self.counter_init <= COUNTER_MAX:
            raise ValueError(f"counter_init out of range: {self.counter_init}")

    def flags(self) -> np.ndarray:
        f = np.zeros(N_FLAGS, dtype=np.int32)
        f[FLAG_COMP] = self.comp
        f[FLAG_LLP] = self.llp
        f[FLAG_META] = self.meta
        f[FLAG_NEXTLINE] = self.nextline
        f[FLAG_IDEAL] = self.ideal
        f[FLAG_DYNAMIC] = self.dynamic
        f[FLAG_LCT_UPDATE] = (
            self.llp if self.lct_update is None else self.lct_update)
        return f

    def params(self, cfg: SimConfig) -> np.ndarray:
        p = np.zeros(N_PARAMS, dtype=np.int32)
        p[PARAM_LCT_SIZE] = self.lct_size
        rate = cfg.sample_rate if self.sample_rate is None else self.sample_rate
        p[PARAM_SAMPLE_THRESH] = sample_threshold(rate)
        p[PARAM_COUNTER_INIT] = self.counter_init
        ms = cfg.meta_sets if self.meta_sets is None else self.meta_sets
        if not 1 <= ms <= cfg.meta_sets:
            raise ValueError(
                f"meta_sets must be in [1, {cfg.meta_sets}], got {ms}")
        p[PARAM_META_SETS] = ms
        return p


_REGISTRY: dict[str, Scheme] = {}


def register(scheme: Scheme, *, overwrite: bool = False) -> Scheme:
    if scheme.name in _REGISTRY and not overwrite:
        raise ValueError(f"scheme {scheme.name!r} is already registered")
    _REGISTRY[scheme.name] = scheme
    return scheme


def get(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scheme(s) {[name]!r}; valid: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve(scheme: "str | Scheme") -> Scheme:
    return scheme if isinstance(scheme, Scheme) else get(scheme)


def variant(base: "str | Scheme", name: str, *,
            overwrite: bool = False, **overrides) -> Scheme:
    """Derive a registry entry from an existing scheme (config ablations)."""
    sch = dataclasses.replace(resolve(base), name=name, **overrides)
    return register(sch, overwrite=overwrite)


def flags_matrix(schemes) -> np.ndarray:
    """(S, N_FLAGS) int32 flag matrix for the requested schemes."""
    unknown = [s for s in schemes
               if not isinstance(s, Scheme) and s not in _REGISTRY]
    if unknown:
        raise KeyError(
            f"unknown scheme(s) {unknown!r}; valid: {sorted(_REGISTRY)}")
    return np.stack([resolve(s).flags() for s in schemes])


def params_matrix(schemes, cfg: SimConfig = SimConfig()) -> np.ndarray:
    """(S, N_PARAMS) int32 config matrix — the vmappable config axis."""
    return np.stack([resolve(s).params(cfg) for s in schemes])


# ---------------------------------------------------------------- built-ins

BASE_SCHEMES = tuple(register(s).name for s in (
    Scheme("baseline", codec="raw",
           description="uncompressed memory (the normalization target)"),
    Scheme("nextline", codec="raw", nextline=True,
           description="uncompressed + next-line prefetch on miss (Table V)"),
    Scheme("ideal", comp=True, ideal=True,
           description="compression benefits, zero maintenance (Fig. 3/16)"),
    Scheme("explicit", comp=True, meta=True,
           description="CRAM strawman: explicit metadata behind a 32KB "
                       "metadata cache (Fig. 7/12)"),
    Scheme("cram", comp=True, llp=True,
           description="CRAM: implicit metadata + LLP, always compress "
                       "(Fig. 12/16)"),
    Scheme("dynamic", comp=True, llp=True, dynamic=True,
           description="Dynamic-CRAM: set-sampled cost/benefit gate "
                       "(Fig. 16/18)"),
))

register(Scheme(
    "cram-nollp", comp=True, llp=True, lct_update=False,
    description="CRAM with the LCT frozen at level 0 (static prediction) — "
                "the probe-chain cost without the predictor, quantifying "
                "the LLP's value"))

# Fig. 14-style LCT-size sensitivity: a config axis, one dispatch with the
# base schemes (cram itself is the 512-entry point).
LCT_SENSITIVITY = tuple(
    variant("cram", f"cram@lct{n}", lct_size=n,
            description=f"cram with a {n}-entry LCT (size sensitivity)").name
    for n in (64, 128, 256)
)
