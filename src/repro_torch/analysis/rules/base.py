"""Rule base class and the AST helpers the rules share."""

from __future__ import annotations

import ast

RULES: dict[str, "Rule"] = {}


class Rule:
    """One invariant.  Subclasses set `name` (r1..r6), `title` (one line,
    lands in the report), and implement `check(ctx)`; `ctx.tree` is None
    for a CUDA source."""

    name: str = ""
    title: str = ""

    def check(self, ctx) -> list:
        raise NotImplementedError


def register(cls):
    inst = cls()
    assert inst.name and inst.name not in RULES, inst.name
    RULES[inst.name] = inst
    return cls


# ---------------------------------------------------------------- AST helpers


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('np.asarray',
    'self.ledger.record', '' when not a plain attribute chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def method_name(call: ast.Call) -> str:
    """The attribute a call invokes ('item' for `x.sum().item()`), or ''
    for a call of a plain name."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


def walk_functions(tree: ast.Module):
    """Yield (node, qualname) for every function/method, with class and
    enclosing-function prefixes ('SlotKVCache.megastep',
    'build_engine.run_chunk')."""

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield child, q
                yield from visit(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def int_constants(tree: ast.AST):
    """Yield (value, node) for every int literal (bools excluded)."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, int)
                and not isinstance(node.value, bool)):
            yield node.value, node
