"""Static analysis and runtime guards for the port's serving contracts
(port of ``repro.analysis``).

* ``repro_torch.analysis.lint`` — AST contract linter
  (``python -m repro_torch.analysis.lint src/repro_torch/``), rules R001,
  R003 and R004 (``rules.py`` says why R002 and R005 are not ported).
* ``repro_torch.analysis.sync_guard`` — counts host syncs, dispatched
  aten ops and kernel launches inside a scope (``SyncGuard``) and per
  test (``@pytest.mark.sync_budget(n)``): the runtime tripwire for the
  device round trips the linter cannot see through objects.
"""
from repro_torch.analysis.engine import (Finding, LintContext, Rule, SourceFile,
                                         default_rules, render_json, render_text,
                                         run_lint)
from repro_torch.analysis.rules import ALL_RULES

__all__ = [
    "ALL_RULES", "Finding", "LintContext", "Rule", "SourceFile",
    "default_rules", "render_json", "render_text", "run_lint",
]
