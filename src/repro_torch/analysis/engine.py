"""Rule-engine core: file walking, rule dispatch and the JSON report.

A rule is a plugin (see `rules/__init__.py`) with a `name`, a one-line
`title` and a `check(ctx) -> list[Violation]`.  The engine parses each
Python file once and hands every rule the same `FileContext`; a CUDA
source (`.cu` / `.cuh`) reaches the rules with `tree=None`, and only the
rules that read CUDA sources (R1) look at it.
"""

from __future__ import annotations

import ast
from dataclasses import asdict, dataclass, field
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class FileContext:
    path: Path         # absolute
    rel: str           # repo-relative posix (or absolute posix if outside)
    source: str
    tree: ast.Module | None     # None for a CUDA source
    root: Path = field(default=REPO_ROOT)

    def violation(self, node: ast.AST | int, rule: str,
                  message: str) -> Violation:
        line = node if isinstance(node, int) else getattr(node, "lineno", 0)
        return Violation(rule=rule, path=self.rel, line=line, message=message)


def default_paths(root: Path | None = None) -> list[Path]:
    """The port's package (its `.py` files and its CUDA sources) and
    `chip_smoke.py`."""
    root = root or REPO_ROOT
    return [root / "src" / "repro_torch", root / "chip_smoke.py"]


def iter_source_files(paths) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*")
                                if f.suffix in (".py",) + CUDA_SUFFIXES))
        elif p.suffix in (".py",) + CUDA_SUFFIXES:
            files.append(p)
    return files


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.resolve().as_posix()


def analyze(paths=None, rules=None, root: Path | None = None
            ) -> list[Violation]:
    """Run the rule registry over `paths` (default: `default_paths`).
    Returns every violation, file-ordered."""
    from .rules import get_rules

    root = Path(root) if root else REPO_ROOT
    active = get_rules(rules)
    out: list[Violation] = []
    for path in iter_source_files(paths or default_paths(root)):
        source = path.read_text()
        tree = None
        if path.suffix == ".py":
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                out.append(Violation(rule="parse", path=_rel(path, root),
                                     line=e.lineno or 0,
                                     message=f"syntax error: {e.msg}"))
                continue
        ctx = FileContext(path=path, rel=_rel(path, root), source=source,
                          tree=tree, root=root)
        for rule in active:
            out.extend(rule.check(ctx))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def render_report(violations: list[Violation], *, files_scanned: int,
                  audit: dict | None = None) -> dict:
    """The JSON report: rule titles, counts by rule, every violation and,
    when it ran, the launch audit."""
    from .rules import get_rules

    counts: dict[str, int] = {}
    for v in violations:
        counts[v.rule] = counts.get(v.rule, 0) + 1
    report = {
        "ok": not violations and not (audit or {}).get("mismatches"),
        "files_scanned": files_scanned,
        "rules": {r.name: r.title for r in get_rules(None)},
        "counts": counts,
        "violations": [asdict(v) for v in violations],
    }
    if audit is not None:
        report["launch_audit"] = audit
    return report
