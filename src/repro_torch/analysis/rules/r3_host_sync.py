"""R3 — hot paths stay on the card: no host syncs in the serving hot
methods or in the functions the launch audit runs.

An N-step serve run costs O(1) host ledger records, and the decode step
is host-bound already; one stray `.item()` or `.cpu()` re-serialises the
card every step, and the CPU tests never notice.  Two scopes, different
strictness:

  * hot-NAMED methods (`step`, `step_all`, `attend`, `repack`,
    `megastep`, `prefill`, ...) are host orchestrators — numpy
    bookkeeping of HOST state is legitimate there, but reading a tensor
    back is not: flag `.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
    `torch.cuda.synchronize` and per-step ledger record/absorb;
  * the functions `launch_audit.AUDITED` names (the port has no jit: these
    are the bodies the reference traces) are held to the strict scope
    besides: no `np.asarray` / `np.array` / `np.ascontiguousarray`, no
    `float()` / `int()` / `bool()` of an expression, and no op whose
    output size depends on the data (`nonzero`, `unique`,
    `masked_select`), each of which syncs on a CUDA tensor.  Host
    bookkeeping goes to helpers of its own.
"""

from __future__ import annotations

import ast

from .base import Rule, call_name, method_name, register, walk_functions

HOT_NAMES = frozenset({
    "step", "step_all", "attend", "repack", "account_step",
    "append_active", "_absorb_step", "megastep", "prefill",
    "prefill_slot", "_prefill",
})

_READBACK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_STRICT_CALLS = frozenset({
    "np.asarray", "np.array", "np.ascontiguousarray", "numpy.asarray",
    "numpy.array", "torch.nonzero", "torch.unique", "torch.masked_select",
})
_STRICT_METHODS = frozenset({"nonzero", "unique", "masked_select"})


def audited() -> dict[str, frozenset[str]]:
    """{path suffix: qualnames} of the functions the launch audit runs."""
    from ..launch_audit import AUDITED

    out: dict[str, set] = {}
    for spec in AUDITED.values():
        for item in spec:
            path, _, qual = item.partition(":")
            out.setdefault(path, set()).add(qual)
    return {p: frozenset(q) for p, q in out.items()}


def _is_ledger_call(call: ast.Call) -> bool:
    name = call_name(call)
    head, _, tail = name.rpartition(".")
    return tail in ("record", "absorb") and "ledger" in head.lower()


def _scan_body(fn: ast.FunctionDef, ctx, rule, *, strict: bool):
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name, meth = call_name(node), method_name(node)
        if meth in _READBACK_METHODS and not node.args:
            out.append(ctx.violation(
                node, rule, f"'.{meth}()' reads a tensor back to the host "
                f"inside hot path '{fn.name}'"))
        elif meth == "synchronize" or name.endswith("synchronize"):
            out.append(ctx.violation(
                node, rule, f"'{name or meth}' inside hot path '{fn.name}' "
                "— sync at the window boundary instead"))
        elif _is_ledger_call(node):
            out.append(ctx.violation(
                node, rule, "per-step ledger booking inside hot path "
                f"'{fn.name}' — use the device accumulator and fold at "
                "the report boundary"))
        elif strict and (name in _STRICT_CALLS
                         or (meth in _STRICT_METHODS and not name.startswith(
                             ("np.", "numpy.")))):
            out.append(ctx.violation(
                node, rule, f"'{name or meth}' inside audited '{fn.name}' "
                "— host materialisation or a data-dependent shape"))
        elif strict and name in ("float", "int", "bool") and node.args \
                and not isinstance(node.args[0], ast.Constant):
            out.append(ctx.violation(
                node, rule, f"'{name}()' of an expression inside audited "
                f"'{fn.name}' — keep host bookkeeping in a helper"))
    return out


@register
class HostSyncInHotPath(Rule):
    name = "r3"
    title = ("no ledger record or host sync (.item, .cpu, .numpy, "
             "synchronize) in step/attend/repack hot paths, and none of "
             "np.asarray/int()/nonzero in the launch audit's functions")

    def check(self, ctx):
        if ctx.tree is None:
            return []
        strict = next((q for p, q in audited().items()
                       if ctx.rel.endswith(p)), frozenset())
        out = []
        for fn, qual in walk_functions(ctx.tree):
            if qual in strict:
                out.extend(_scan_body(fn, ctx, self.name, strict=True))
            elif fn.name in HOT_NAMES:
                out.extend(_scan_body(fn, ctx, self.name, strict=False))
        return out
