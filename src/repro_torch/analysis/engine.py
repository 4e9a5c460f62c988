"""Rule engine of the port's contract linter (port of
``repro.analysis.engine``).

The port's serving stack is correct only by convention: cache writes
that drop dead rows, ``fold_in(seed, position)`` keying, no device
round trip inside the forward beyond the ones a tick is known to pay.
This package turns those conventions into machine-checked rules (see
``rules.py`` for the catalogue).

This module is the rule-agnostic machinery, the reference's own:

  * ``SourceFile`` — parsed file (AST + per-line suppression comments);
  * ``Finding`` — one diagnostic, with an optional ``fixit`` suggestion;
  * ``Rule`` — base class; rules yield findings from (file, context);
  * ``LintContext`` — project-wide state shared by rules (every parsed
    file plus the device call graph from ``callgraph.py``);
  * ``run_lint`` — drive rules over files, apply suppressions, report.

Suppression syntax (the only sanctioned way to silence a true-but-
intentional violation)::

    bi, ti = keep.nonzero(as_tuple=True)  # repro: ignore[R001] why

A suppression must name the rule id and carry a non-empty reason; a
reasonless ``# repro: ignore[R00x]`` does NOT suppress — the finding stays
and an R000 diagnostic is added, so "silenced without justification" can
never pass. A suppression comment on its own line applies to the next
statement; one at end-of-line applies to the statement covering that line.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore\[([A-Za-z0-9,\s]+)\]\s*(.*?)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``line``/``end_line`` delimit the statement the
    suppression scanner searches for ``# repro: ignore[...]`` comments."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    fixit: Optional[str] = None
    end_line: Optional[int] = None
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        if d["end_line"] is None:
            d["end_line"] = d["line"]
        return d


class SourceFile:
    """A parsed source file plus its suppression table."""

    def __init__(self, path: str, text: str, module: Optional[str] = None):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.module = module if module is not None else module_name(path)
        # line -> {rule_id -> reason}; "" reason marks an invalid suppression
        self.suppressions: Dict[int, Dict[str, str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = [r.strip().upper() for r in m.group(1).split(",")]
            reason = m.group(2).strip()
            table = self.suppressions.setdefault(i, {})
            for r in rules:
                if r:
                    table[r] = reason

    def suppression_for(self, rule: str, line: int,
                        end_line: Optional[int] = None) -> Optional[str]:
        """Reason string if ``rule`` is suppressed anywhere on the
        statement's lines or the line directly above it; None otherwise.
        An empty reason is NOT a valid suppression (returns None)."""
        lo, hi = line, end_line if end_line is not None else line
        for ln in range(max(lo - 1, 1), hi + 1):
            reason = self.suppressions.get(ln, {}).get(rule)
            if reason:
                return reason
        return None

    def has_reasonless_suppression(self, rule: str, line: int,
                                   end_line: Optional[int] = None) -> bool:
        lo, hi = line, end_line if end_line is not None else line
        for ln in range(max(lo - 1, 1), hi + 1):
            if self.suppressions.get(ln, {}).get(rule) == "":
                return True
        return False


def module_name(path: str) -> str:
    """Dotted module name of ``path``, rooted at the last ``src/`` (or the
    first ``repro_torch`` component) so call-graph edges can be resolved
    through absolute ``repro_torch.*`` imports."""
    parts = path.replace("\\", "/").split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    for anchor in ("src", "repro_torch"):
        if anchor in parts:
            i = parts.index(anchor)
            parts = parts[i + 1:] if anchor == "src" else parts[i:]
            break
    return ".".join(p for p in parts if p) or parts[-1]


class LintContext:
    """Project-wide state shared by every rule: all parsed files plus the
    device call graph (built lazily on first access)."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = list(files)
        self.by_module: Dict[str, SourceFile] = {f.module: f for f in files}
        self._graph = None

    @property
    def graph(self):
        if self._graph is None:
            from repro_torch.analysis.callgraph import CallGraph
            self._graph = CallGraph(self.files)
        return self._graph


class Rule:
    """Base class. Subclasses set ``id``/``title``/``contract`` and yield
    ``Finding`` objects from ``check``."""

    id: str = "R000"
    title: str = ""
    # one-line statement of the repo contract the rule enforces
    contract: str = ""

    def check(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    # helper: build a finding anchored at an AST node
    def finding(self, src: SourceFile, node: ast.AST, message: str,
                fixit: Optional[str] = None) -> Finding:
        return Finding(
            rule=self.id, path=src.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            end_line=getattr(node, "end_lineno", None),
            message=message, fixit=fixit)


def default_rules() -> List[Rule]:
    from repro_torch.analysis.rules import ALL_RULES
    return [cls() for cls in ALL_RULES]


def run_lint(sources: Iterable[Tuple[str, str]],
             rules: Optional[Sequence[Rule]] = None,
             ) -> Tuple[List[Finding], LintContext]:
    """Lint ``(path, text)`` pairs. Returns (findings, context): every
    finding, with ``suppressed``/``suppress_reason`` filled in, sorted by
    (path, line, rule). Reasonless suppressions surface as R000 findings."""
    files: List[SourceFile] = []
    findings: List[Finding] = []
    for path, text in sources:
        try:
            files.append(SourceFile(path, text))
        except SyntaxError as e:
            findings.append(Finding(
                rule="R000", path=path, line=e.lineno or 1, col=e.offset or 0,
                message=f"syntax error: {e.msg}"))
    ctx = LintContext(files)
    rules = list(rules) if rules is not None else default_rules()
    for src in files:
        for rule in rules:
            for f in rule.check(src, ctx):
                reason = src.suppression_for(f.rule, f.line, f.end_line)
                if reason is not None:
                    f = dataclasses.replace(
                        f, suppressed=True, suppress_reason=reason)
                elif src.has_reasonless_suppression(f.rule, f.line, f.end_line):
                    findings.append(Finding(
                        rule="R000", path=src.path, line=f.line, col=f.col,
                        message=(f"suppression of {f.rule} has no reason — "
                                 f"add one: # repro: ignore[{f.rule}] <why>")))
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.col))
    return findings, ctx


# ==========================================================================
# Reporters
# ==========================================================================
def render_text(findings: Sequence[Finding],
                show_suppressed: bool = False) -> str:
    out = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        tag = " (suppressed: %s)" % f.suppress_reason if f.suppressed else ""
        out.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}{tag}")
        if f.fixit and not f.suppressed:
            out.append(f"    fix: {f.fixit}")
    active = sum(1 for f in findings if not f.suppressed)
    sup = len(findings) - active
    out.append(f"{active} finding(s), {sup} suppressed")
    return "\n".join(out)


def render_json(findings: Sequence[Finding],
                rules: Optional[Sequence[Rule]] = None) -> str:
    doc = {
        "findings": [f.to_json() for f in findings],
        "active": sum(1 for f in findings if not f.suppressed),
        "suppressed": sum(1 for f in findings if f.suppressed),
    }
    if rules is not None:
        doc["rules"] = [
            {"id": r.id, "title": r.title, "contract": r.contract}
            for r in rules]
    return json.dumps(doc, indent=2, sort_keys=True)
