"""R6 — kernel wrappers never swallow errors or make float64.

A wrapper that catches a failed launch and carries on (or falls back to
the plain version) turns a mis-built kernel into wrong numbers, or into
a card run that silently measures the CPU path: the port's wrappers
launch the kernel on a CUDA tensor or raise.  A float64 tensor doubles
the bytes the byte model charges for and has no place in a kernel's
inputs.  Scope: `kernels/` (wrappers and the plain versions).
"""

from __future__ import annotations

import ast

from .base import Rule, call_name, dotted_name, register

F64_NAMES = frozenset({"torch.float64", "torch.double", "np.float64",
                       "numpy.float64"})


def _reraises(h: ast.ExceptHandler) -> bool:
    """True when every path out of the handler raises: its last statement
    is a `raise`."""
    return bool(h.body) and isinstance(h.body[-1], ast.Raise)


def _is_python_float(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "float"


@register
class KernelHygiene(Rule):
    name = "r6"
    title = ("no except that swallows an error or falls back, and no "
             "float64, in kernel wrappers")

    def check(self, ctx):
        if ctx.tree is None or "repro_torch/kernels/" not in ctx.rel:
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler):
                if node.type is None:
                    out.append(ctx.violation(
                        node, self.name,
                        "bare 'except:' in a kernel wrapper"))
                elif not _reraises(node):
                    out.append(ctx.violation(
                        node, self.name,
                        "exception handler that does not re-raise in a "
                        "kernel wrapper — a swallowed launch error or a "
                        "fallback to the plain version is wrong numbers"))
            elif isinstance(node, ast.Attribute) and \
                    dotted_name(node) in F64_NAMES:
                out.append(ctx.violation(
                    node, self.name,
                    f"{dotted_name(node)} in kernel code — doubles the "
                    "bytes moved"))
            elif isinstance(node, ast.Call):
                name = call_name(node)
                promotes = name.endswith(".double") and not node.args
                promotes |= (name.endswith((".astype", ".to", ".type"))
                             and any(_is_python_float(a) for a in node.args))
                promotes |= any(kw.arg == "dtype" and _is_python_float(
                    kw.value) for kw in node.keywords)
                if promotes:
                    out.append(ctx.violation(
                        node, self.name,
                        "float64 in kernel code ('.double()' or a python "
                        "'float' dtype)"))
        return out
