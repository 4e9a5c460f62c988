"""The port's contract linter (repro_torch.analysis): per-rule true-positive
and clean fixtures in torch idiom, the device call graph's seeds and
edges, suppression semantics (reasoned / reasonless), reporters and CLI
exits — the cases of ``tests/test_analysis.py`` for R001, R003 and R004 —
and the rule-agnostic engine held against ``repro.analysis.engine``.

Every fixture is linted in memory via ``run_lint`` on (path, text) pairs;
paths are chosen to exercise the path-scoped rules (R003 fires only under
models//serving/) and the seeds ``DEVICE_SEEDS`` names by module.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import engine as jengine
from repro_torch.analysis import engine as tengine
from repro_torch.analysis import run_lint
from repro_torch.analysis.callgraph import DEVICE_SEEDS
from repro_torch.analysis.engine import render_json, render_text
from repro_torch.analysis.lint import main as lint_main
from repro_torch.testing import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MODEL = "src/repro_torch/models/transformer.py"


def lint(*sources):
    """sources: (path, code) pairs; returns the findings list."""
    findings, _ = run_lint(
        [(p, textwrap.dedent(code)) for p, code in sources])
    return findings


def active(findings, rule=None):
    return [f for f in findings if not f.suppressed
            and (rule is None or f.rule == rule)]


class TestR001HostSync:
    def test_true_positive_in_seed(self):
        fs = lint((MODEL, """
            def model_apply(params, x):
                return int(x.max())
        """))
        (f,) = active(fs, "R001")
        assert "int()" in f.message and "model_apply" in f.message

    def test_true_positive_through_call_graph(self):
        """helper is reachable only through an autograd.Function's
        forward, a seed of its own."""
        fs = lint(("src/repro_torch/kernels/k.py", """
            import torch

            def helper(v):
                return v.item()

            class Op(torch.autograd.Function):
                @staticmethod
                def forward(ctx, a):
                    return helper(a)
        """))
        (f,) = active(fs, "R001")
        assert ".item()" in f.message and "helper" in f.message

    @pytest.mark.parametrize("expr, needle", [
        ("x.cpu()", ".cpu()"), ("x.tolist()", ".tolist()"),
        ("keep.nonzero(as_tuple=True)", ".nonzero()"),
        ("torch.nonzero(keep)", "torch.nonzero()"),
        ("x.masked_select(keep)", ".masked_select()"),
        ("np.asarray(x)", "np.asarray()")])
    def test_true_positive_reads_and_data_shaped_ops(self, expr, needle):
        """A kernel wrapper (it calls a C entry point on the ctypes
        library) is a seed."""
        fs = lint(("src/repro_torch/kernels/k.py", f"""
            import numpy as np
            import torch

            def wrapper(x, keep):
                y = {expr}
                return _kernel_lib().k_launch(x.data_ptr())
        """))
        (f,) = active(fs, "R001")
        assert needle in f.message and "wrapper" in f.message

    def test_true_positive_truth_test_of_reduction(self):
        fs = lint((MODEL, """
            def model_apply(params, x):
                if (x < 0).any():
                    raise ValueError("negative")
                return x
        """))
        (f,) = active(fs, "R001")
        assert "truth test" in f.message

    def test_true_positive_across_modules(self):
        """Edges through ``from repro_torch.x import fn`` and through an
        imported module's attribute."""
        fs = lint(
            (MODEL, """
                import repro_torch.nn.b as nb
                from repro_torch.nn.a import first

                def model_apply(params, x):
                    return first(x) + nb.second(x)
            """),
            ("src/repro_torch/nn/a.py", """
                def first(v):
                    return float(v.sum())
            """),
            ("src/repro_torch/nn/b.py", """
                def second(v):
                    return v.cpu()

                def unused(v):
                    return v.item()
            """))
        assert sorted(f.message.split("`")[-2] for f in active(fs, "R001")) == \
            ["first", "second"]

    def test_clean_host_side_code(self):
        """The scheduler idiom: host code reading the tick's result AFTER
        it ran is fine — it is not device-reachable."""
        fs = lint(("src/repro_torch/serving/decode.py", """
            import numpy as np

            def step_rows_full(params, tokens):
                return tokens * 2

            def drive(params, tokens):
                y = step_rows_full(params, tokens)
                return int(y.max()), y.cpu().numpy(), np.asarray(y)
        """))
        assert not active(fs, "R001")

    def test_clean_shape_access_kills_taint(self):
        fs = lint((MODEL, """
            def model_apply(params, tokens):
                b, t = tokens.shape
                n = tokens.size(0) * tokens.numel()
                return tokens.reshape(int(b * t + n), len(tokens))
        """))
        assert not active(fs, "R001")

    def test_clean_annotated_python_values(self):
        """int/Config-annotated params and locals are host values."""
        fs = lint((MODEL, """
            def model_apply(params, x, width: int, cfg: ModelConfig, task):
                mb: int = task.microbatch
                return x * int(width) * float(cfg.scale) / float(mb)
        """))
        assert not active(fs, "R001")

    def test_seeds_name_the_ports_per_forward_functions(self):
        assert DEVICE_SEEDS == (
            "repro_torch.models.transformer:model_apply",
            "repro_torch.serving.decode:step_rows_full",
            "repro_torch.serving.decode:sample_rows",
            "repro_torch.train.step:make_train_step.train_step")


class TestR003MaskedWrite:
    def test_true_positive_unguarded_cache_write(self):
        fs = lint(("src/repro_torch/serving/s.py", """
            def write(cache, idx, v):
                cache["k"][idx] = v
                cache["v"].index_copy_(0, idx, v)
                return cache
        """))
        assert len(active(fs, "R003")) == 2
        assert all("masked target" in f.message for f in active(fs, "R003"))

    def test_clean_masked_targets(self):
        """The model's write idiom verbatim: targets from _paged_targets,
        passed on as ``targets``, or kept in a table; a torch.where index."""
        fs = lint((MODEL, """
            import torch

            def _paged_write(cache, k, targets):
                bi, ti, blk, slot = targets
                cache["k"][blk, slot] = k[bi, ti]

            def attend(cache, k, st, table, act, idx):
                key = table.data_ptr()
                st.write_idx[key] = _paged_targets(table, st.tpos, st.act_tok)
                bi, ti, slot = st.write_idx[key]
                cache["v"][bi, slot] = k[bi, ti]
                widx = torch.where(act, idx, 4096)
                cache["pos_ids"].index_put_((widx,), k)
        """))
        assert not active(fs, "R003")

    def test_clean_closure_write_and_non_writes(self):
        """A closure writes with its enclosing function's targets; slice
        writes (the shared-position write) and dict stores are not
        scatters."""
        fs = lint((MODEL, """
            def ring(cache: dict, k, targets, s0, t, new):
                bi, ti, slot = targets

                def write():
                    cache["k"][bi, slot] = k[bi, ti]

                write()
                cache["v"][:, s0:s0 + t] = k
                cache["k_scale"] = new
                cache[s0] = new
        """))
        assert not active(fs, "R003")

    def test_out_of_scope_paths_exempt(self):
        fs = lint(("src/repro_torch/train/t.py", """
            def write(pool_cache, idx, v):
                pool_cache[idx] = v
        """))
        assert not active(fs, "R003")


class TestR004Prng:
    def test_true_positive_double_draw(self):
        fs = lint(("src/repro_torch/m.py", """
            from repro_torch.random import gumbel, uniform

            def sample(key, shape):
                a = uniform(key, shape)
                b = gumbel(key, shape)
                return a + b
        """))
        (f,) = active(fs, "R004")
        assert "reused without split/fold_in" in f.message

    def test_true_positive_loop_reuse(self):
        fs = lint(("src/repro_torch/m.py", """
            import repro_torch.random as rnd

            def loop(key, xs):
                out = []
                for x in xs:
                    out.append(rnd.uniform(key, x.shape))
                return out
        """))
        (f,) = active(fs, "R004")
        assert "loop" in f.message

    def test_clean_split_between_draws(self):
        fs = lint(("src/repro_torch/m.py", """
            from repro_torch.random import split, uniform

            def sample(key, shape):
                a = uniform(key, shape)
                key = split(key)[0]
                b = uniform(key, shape)
                return a + b
        """))
        assert not active(fs, "R004")

    def test_clean_fold_in_loop(self):
        """The serving position-keyed idiom; a draw of another module's
        ``uniform`` is not a key draw."""
        fs = lint(("src/repro_torch/m.py", """
            import random
            from repro_torch.random import categorical, fold_in

            def sample(key, xs):
                out = []
                for i, x in enumerate(xs):
                    k = fold_in(key, i)
                    out.append(categorical(k, x))
                    out.append(random.uniform(key, 1.0))
                    out.append(random.uniform(key, 2.0))
                return out
        """))
        assert not active(fs, "R004")


class TestSuppressions:
    SRC = """
        def model_apply(params, counts):
            t = int(counts.max())  {comment}
            return t
    """

    def test_reasoned_suppression_silences(self):
        fs = lint((MODEL, self.SRC.format(
            comment="# repro: ignore[R001] exact length required here")))
        assert not active(fs)
        (sup,) = [f for f in fs if f.suppressed]
        assert sup.suppress_reason == "exact length required here"

    def test_reasonless_suppression_rejected(self):
        fs = lint((MODEL, self.SRC.format(comment="# repro: ignore[R001]")))
        assert active(fs, "R001")
        assert any(f.rule == "R000" and "no reason" in f.message for f in fs)

    def test_wrong_rule_id_does_not_suppress(self):
        fs = lint((MODEL, self.SRC.format(
            comment="# repro: ignore[R003] not the firing rule")))
        assert active(fs, "R001")

    def test_suppression_on_preceding_line(self):
        fs = lint((MODEL, """
            def model_apply(params, counts):
                # repro: ignore[R001] exact length required here
                t = int(counts.max())
                return t
        """))
        assert not active(fs)


class TestReportersAndCli:
    BAD = """
        def model_apply(params, x):
            return int(x.max())
    """

    def test_json_reporter_shape(self):
        fs = lint((MODEL, self.BAD))
        doc = json.loads(render_json(fs))
        assert doc["active"] == 1 and doc["suppressed"] == 0
        (j,) = doc["findings"]
        assert j["rule"] == "R001" and j["path"] == MODEL
        assert j["line"] >= 1 and j["fixit"]

    def test_text_reporter_counts(self):
        txt = render_text(lint((MODEL, self.BAD)))
        assert "1 finding(s), 0 suppressed" in txt
        assert f"{MODEL}:" in txt and "fix:" in txt

    def test_syntax_error_is_finding_not_crash(self):
        (f,) = active(lint(("m.py", "def broken(:\n")), "R000")
        assert "syntax error" in f.message

    def test_cli_exit_codes(self, tmp_path, capsys):
        pkg = tmp_path / "src" / "repro_torch" / "models"
        pkg.mkdir(parents=True)
        bad = pkg / "transformer.py"
        bad.write_text(textwrap.dedent(self.BAD))
        ok = tmp_path / "ok.py"
        ok.write_text("x = 1\n")
        assert lint_main([str(bad)]) == 1
        assert lint_main([str(ok)]) == 0
        assert lint_main([str(tmp_path / "missing.py")]) == 2
        assert lint_main([str(bad), "--rules", "R002"]) == 2
        assert lint_main([str(bad), "--rules", "R003,R004"]) == 0
        assert lint_main([str(bad), "--format", "json"]) == 1
        assert lint_main(["--list-rules", str(ok)]) == 0
        out = capsys.readouterr().out
        assert "R001" in out and "R005" not in out

    def test_port_tree_is_clean(self):
        """The gate: the port's tree lints clean under its own rules, run
        as a user runs it."""
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch/"],
            cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip().startswith("0 finding(s)")


class TestRuleCatalogue:
    def test_three_rules_active_with_contracts(self):
        from repro_torch.analysis import ALL_RULES
        assert [r.id for r in ALL_RULES] == ["R001", "R003", "R004"]
        for cls in ALL_RULES:
            r = cls()
            assert r.title and r.contract


# --------------------------------------------------------------------------
# the engine against the reference's
# --------------------------------------------------------------------------
SHARED = """
    def tick(counts):
        print(counts)  # repro: ignore[T001] shown on purpose

        print("a")  # repro: ignore[T001]

        # repro: ignore[T001] preceding-line suppression
        print(
            "b")

        print("c")  # repro: ignore[T002] not the firing rule
        return counts
"""


def _print_rule(base):
    class PrintRule(base.Rule):
        id = "T001"
        title = "no print"
        contract = "libraries do not print"

        def check(self, src, ctx):
            import ast
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call) and \
                        getattr(node.func, "id", None) == "print":
                    yield self.finding(src, node, "print call",
                                       fixit="log instead")

    return PrintRule()


@pytest.mark.parametrize("show_suppressed", [False, True])
def test_engine_reports_equal_the_reference(show_suppressed):
    sources = [("src/repro_torch/serving/m.py", textwrap.dedent(SHARED)),
               ("m.py", "def broken(:\n"), ("ok.py", "x = 1\n")]
    out = {}
    for name, eng in (("ref", jengine), ("port", tengine)):
        rules = [_print_rule(eng)]
        findings, _ = eng.run_lint(sources, rules=rules)
        out[name] = (eng.render_json(findings, rules=rules),
                     eng.render_text(findings, show_suppressed=show_suppressed))
    assert out["port"] == out["ref"]
    doc = json.loads(out["port"][0])
    assert (doc["active"], doc["suppressed"]) == (4, 2)


@pytest.mark.parametrize("path", [
    "m.py", "src/repro/serving/s.py", "src/repro_torch/models/transformer.py",
    "x/src/repro_torch/nn/__init__.py", "repro/serving/s.py"])
def test_module_name_equals_the_reference_on_shared_paths(path):
    assert tengine.module_name(path) == jengine.module_name(path)


def test_module_name_roots_the_port_package():
    assert tengine.module_name("lib/repro_torch/models/transformer.py") == \
        "repro_torch.models.transformer"
