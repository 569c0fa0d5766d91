"""R4 — no process-salted or global-state seeding.

Builtin `hash()` is salted per process (PYTHONHASHSEED), so seeding
anything from it makes runs unreproducible.  Global seeding
(`np.random.seed`, `random.seed`, `torch.manual_seed`,
`torch.cuda.manual_seed[_all]`) mutates process state behind every
other consumer's back; the port seeds through an explicit
`torch.Generator` or `np.random.default_rng(seed)`.
"""

from __future__ import annotations

import ast

from .base import Rule, call_name, register

GLOBAL_SEEDING = frozenset({
    "np.random.seed", "numpy.random.seed", "random.seed",
    "torch.manual_seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
})


@register
class SaltedSeeding(Rule):
    name = "r4"
    title = "no hash()/process-salted or global-state seeding"

    def check(self, ctx):
        if ctx.tree is None:
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name == "hash":
                out.append(ctx.violation(
                    node, self.name,
                    "builtin hash() is salted per process "
                    "(PYTHONHASHSEED) — derive seeds with zlib.crc32 or "
                    "np.random.default_rng"))
            elif name in GLOBAL_SEEDING:
                out.append(ctx.violation(
                    node, self.name,
                    f"global-state seeding '{name}' — pass an explicit "
                    "torch.Generator or np.random.default_rng(seed) "
                    "instead"))
        return out
