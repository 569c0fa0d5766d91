"""R2 — codec/layout implementations stay behind the compression registry.

Outside the registry surface (compression/ itself, the core/ shims and
kernels/, the registry's device backends), a module may consume codecs
only through the public API (`get_codec`, `get_layout`, framing, marker,
gate, predictor).  Violations:

  * importing a codec implementation module (fpc/bdi/hybrid/pagepack/bits)
    — except at the two sanctioned integration points, where the registry
    intentionally exposes batch/page helpers;
  * defining a function with a codec-implementation signature name
    (pack_pair, unpack_quad, pack_batch, compressed_sizes, ...);
  * calling np.packbits/np.unpackbits (bit-level packing is codec work).
"""

from __future__ import annotations

import ast

from .base import Rule, call_name, register, walk_functions

IMPL_MODULES = frozenset({"fpc", "bdi", "hybrid", "pagepack", "bits"})

# the registry surface: implementations and their sanctioned re-exports
SURFACE = ("repro_torch/compression/", "repro_torch/core/",
           "repro_torch/kernels/")

# sanctioned integration points: (rel-path suffix, impl module), the
# reference's own two
SANCTIONED = frozenset({
    ("repro_torch/serving/spill.py", "pagepack"),
    ("repro_torch/checkpoint/codec.py", "bdi"),
})

IMPL_DEF_NAMES = frozenset({
    "pack_pair", "unpack_pair", "pack_quad", "unpack_quad",
    "pack_line", "unpack_line", "pack_batch", "unpack_batch",
    "compressed_sizes", "fpc_size_bits", "bdi_sizes", "classify_line",
})


def _on_surface(rel: str) -> bool:
    return any(s in rel for s in SURFACE)


def _imported_impls(tree: ast.Module):
    """Yield (impl_name, node) for every codec-impl module import
    (absolute or relative)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            base = mod.split(".")[-1]
            if base == "compression":
                for alias in node.names:
                    if alias.name in IMPL_MODULES:
                        yield alias.name, node
            elif "compression." in mod + "." and base in IMPL_MODULES:
                yield base, node
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if "compression" in parts and parts[-1] in IMPL_MODULES:
                    yield parts[-1], node


@register
class RegistryBypass(Rule):
    name = "r2"
    title = ("no codec/layout pack-unpack implementations or imports "
             "bypassing the compression registry")

    def check(self, ctx):
        if ctx.tree is None or _on_surface(ctx.rel):
            return []
        out = []
        for impl, node in _imported_impls(ctx.tree):
            if any(ctx.rel.endswith(p) and impl == m
                   for p, m in SANCTIONED):
                continue
            out.append(ctx.violation(
                node, self.name,
                f"imports compression implementation module '{impl}'; "
                "consume it through the registry (get_codec/get_layout) "
                "or sanction the integration point in rule r2"))
        for fn, qual in walk_functions(ctx.tree):
            if fn.name in IMPL_DEF_NAMES:
                out.append(ctx.violation(
                    fn, self.name,
                    f"defines codec-implementation function '{qual}' "
                    "outside the compression registry"))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and call_name(node).endswith(
                    ("packbits", "unpackbits")):
                out.append(ctx.violation(
                    node, self.name,
                    "bit-level packbits/unpackbits outside the registry — "
                    "codec byte layouts live in compression/"))
        return out
