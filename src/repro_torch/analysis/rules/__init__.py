"""The rule registry: one plugin per invariant.

Adding a rule = writing a module with a `@register`-decorated subclass of
`rules.base.Rule` and importing it here.  `get_rules(None)` returns every
registered rule; `get_rules(["r1", "r3"])` a subset by name.
"""

from __future__ import annotations

from .base import RULES, Rule, register

# importing a rule module registers its rule (order fixes report order)
from . import r1_marker_literals    # noqa: E402,F401
from . import r2_registry_bypass    # noqa: E402,F401
from . import r3_host_sync          # noqa: E402,F401
from . import r4_seeding            # noqa: E402,F401
from . import r5_ledger_coverage    # noqa: E402,F401
from . import r6_kernel_hygiene     # noqa: E402,F401


def get_rules(names=None) -> list[Rule]:
    if names is None:
        return list(RULES.values())
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise KeyError(f"unknown rules {unknown}; have {sorted(RULES)}")
    return [RULES[n] for n in names]


__all__ = ["Rule", "RULES", "register", "get_rules"]
