"""R5 — every function that emits bytes across a tier books a ledger
event, and all byte math lives in bandwidth/.

A byte that moves but is never charged makes compression look free.  Two
checks:

  * (a) accounting stays centralized — outside `bandwidth/`, nobody calls
    `<ledger>.record/.absorb` or the device accumulator primitive
    directly; consumers go through the adapter functions
    (`bandwidth/adapters.py`);
  * (b) call-graph coverage — in any module of the package that imports
    from bandwidth.adapters, every tier-crossing function (name contains
    an emitter verb: evict/restore/spill/save/load) must transitively
    reach an imported adapter call.
"""

from __future__ import annotations

import ast

from .base import Rule, call_name, register, walk_functions

EMITTER_VERBS = frozenset({"evict", "restore", "spill", "save", "load"})


def _is_ledger_call(call: ast.Call) -> bool:
    name = call_name(call)
    head, _, tail = name.rpartition(".")
    return tail in ("record", "absorb") and "ledger" in head.lower()


def _adapter_imports(tree: ast.Module) -> set[str]:
    """Names imported from bandwidth.adapters (module- or function-level)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                (node.module or "").endswith("adapters"):
            names.update(a.asname or a.name for a in node.names)
    return names


def _is_emitter(name: str) -> bool:
    return not name.startswith("__") and \
        bool(EMITTER_VERBS & set(name.lower().split("_")))


@register
class LedgerCoverage(Rule):
    name = "r5"
    title = ("every tier-crossing emitter books a ledger event via a "
             "bandwidth/adapters call; byte math never leaves bandwidth/")

    def check(self, ctx):
        if ctx.tree is None:
            return []
        in_bandwidth = "repro_torch/bandwidth/" in ctx.rel
        out = []
        if not in_bandwidth:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call) and _is_ledger_call(node):
                    out.append(ctx.violation(
                        node, self.name,
                        f"direct ledger '{call_name(node)}' outside "
                        "bandwidth/ — book through a bandwidth.adapters "
                        "function"))
                elif isinstance(node, ast.Call) and \
                        call_name(node).endswith("device_record"):
                    out.append(ctx.violation(
                        node, self.name,
                        "device_record outside bandwidth/ — the device "
                        "byte model belongs in bandwidth/adapters"))

        # (b) call-graph coverage over adapter consumers (the package
        # only: chip_smoke orchestrates, it owns no tier crossing)
        if in_bandwidth or "repro_torch/" not in ctx.rel:
            return out
        adapters = _adapter_imports(ctx.tree)
        if not adapters:
            return out
        funcs = dict(walk_functions(ctx.tree))   # node -> qualname
        by_last: dict[str, list[ast.FunctionDef]] = {}
        for node, qual in funcs.items():
            by_last.setdefault(qual.rsplit(".", 1)[-1], []).append(node)

        def calls_in(fn: ast.FunctionDef) -> set[str]:
            return {call_name(n).rsplit(".", 1)[-1]
                    for n in ast.walk(fn) if isinstance(n, ast.Call)}

        def reaches_adapter(fn: ast.FunctionDef, seen: set[int]) -> bool:
            if id(fn) in seen:
                return False
            seen.add(id(fn))
            called = calls_in(fn)
            if called & adapters:
                return True
            return any(reaches_adapter(target, seen)
                       for name in called
                       for target in by_last.get(name, ()))

        for fn, qual in funcs.items():
            if _is_emitter(fn.name) and not reaches_adapter(fn, set()):
                out.append(ctx.violation(
                    fn, self.name,
                    f"tier-crossing '{qual}' never reaches a "
                    f"bandwidth.adapters booking ({sorted(adapters)}) — "
                    "bytes would move unledgered"))
        return out
