"""R1 — marker constants are defined once, in compression/framing.py.

The in-band marker discipline only works if every consumer derives
markers from THE same key and multipliers; a re-typed literal that drifts
from framing's value silently desynchronizes the packers from the
decoders.  The protected set is derived from the port's own framing.py:
every int literal in it that is large enough to be a key or multiplier
and is not a plain mask or power of two.  Any of those values written as
a literal elsewhere is a violation — in a Python module (import the named
constant) or in a CUDA source (`kernels/cuda_lib.py` passes framing's
values to nvcc as -D defines).
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

from .base import Rule, int_constants, register

_EXEMPT_SUFFIX = "compression/framing.py"
_FRAMING = Path(__file__).resolve().parents[2] / "compression" / "framing.py"
_MIN_PROTECTED = 0x1000     # sizes, shifts and small masks live below this

# C/C++ comments and string/char literals, then integer literals with
# their suffixes (u, l, ul, ull, ...)
_C_NOISE = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"|'
                      r"'(?:\\.|[^'\\])*'", re.S)
_C_INT = re.compile(r"(?<![\w.])(0[xX][0-9a-fA-F']+|[1-9][0-9']*|0)"
                    r"(?:[uU][lL]{0,2}|[lL]{1,2}[uU]?)?(?![\w.])")


def _is_mask_like(v: int) -> bool:
    """Powers of two and all-ones masks are generic bit twiddling, not
    marker material."""
    return v <= 0 or (v & (v - 1)) == 0 or (v & (v + 1)) == 0


@functools.lru_cache(maxsize=1)
def protected_constants() -> frozenset[int]:
    tree = ast.parse(_FRAMING.read_text())
    return frozenset(v for v, _ in int_constants(tree)
                     if v >= _MIN_PROTECTED and not _is_mask_like(v))


def cuda_int_literals(source: str):
    """Yield (value, line) for every integer literal of a CUDA source,
    comments and string literals left out."""
    def blank(m):       # keep the line count
        return re.sub(r"[^\n]", " ", m.group(0))

    code = _C_NOISE.sub(blank, source)
    for m in _C_INT.finditer(code):
        text = m.group(1).replace("'", "")
        value = int(text, 16) if text[:2] in ("0x", "0X") else int(text)
        yield value, code.count("\n", 0, m.start()) + 1


@register
class MarkerLiterals(Rule):
    name = "r1"
    title = ("no raw marker-word literals outside compression/framing.py, "
             "in Python or CUDA sources (import or pass the named constant)")

    def check(self, ctx):
        if ctx.rel.endswith(_EXEMPT_SUFFIX):
            return []
        protected = protected_constants()
        found = (int_constants(ctx.tree) if ctx.tree is not None
                 else cuda_int_literals(ctx.source))
        return [ctx.violation(
                    node, self.name,
                    f"marker constant {value:#x} hardcoded; take it from "
                    "repro_torch.compression.framing")
                for value, node in found if value in protected]
