"""The port's contract rules: R001, R003 and R004 (port of
``repro.analysis.rules``).

Each rule keeps the reference's id and encodes the convention in the
port's idiom; the rule docstrings state the exact detection heuristic
(all of them are intentionally *lightweight*: single-pass, syntactic +
local taint, no type inference).

Two rules of the reference are not ported, because what they guard does
not exist in eager PyTorch and CUDA C++:

  * R002 (jit static-arg hygiene) guards ``jax.jit`` against python values
    that retrace per value. Nothing in the port is traced or compiled per
    shape, so a varying python int costs nothing there.
  * R005 (Pallas ``index_map`` / ref-slicing rules) guards Pallas
    BlockSpecs and Mosaic's static slices. The port's kernels are CUDA C++
    under ``csrc/``, which this linter does not parse.

Shared machinery: a local taint analysis. A function's "tainted" names
start at its parameters (minus ones whose annotation marks them as
python scalars/configs; a local so annotated is a host value too) and
flow through assignments; ``.shape`` /
``.dtype`` / ``.size()`` / ``len()`` *kill* taint, because they are host
values that need no device round trip.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import dotted
from repro_torch.analysis.engine import Finding, LintContext, Rule, SourceFile

# annotations that mark a parameter as a host python value: scalars,
# config dataclasses, strings. Anything else (or no annotation) is
# conservatively assumed to hold a tensor.
_HOST_ANN_RE = re.compile(r"\b(int|float|bool|str)\b|Config\b")
# attribute reads that give host values without reading a tensor's data
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "itemsize", "nbytes", "requires_grad", "is_leaf"}
# method calls that give host values without reading a tensor's data
_SHAPE_METHODS = {"size", "dim", "numel", "stride", "data_ptr", "element_size",
                  "get_device", "is_contiguous", "is_floating_point"}
# calls whose *result* is a host python value (the call itself may still
# be a violation — R001 checks that separately)
_UNTAINT_CALLS = {"int", "float", "bool", "str", "len", "isinstance",
                  "hasattr", "getattr", "range", "type", "repr"}
# device -> host reads: their results live on the host
_HOST_READS = {"item", "tolist", "cpu", "numpy"}


def iter_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _all_args(fn: ast.FunctionDef) -> List[ast.arg]:
    a = fn.args
    out = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    if a.vararg:
        out.append(a.vararg)
    if a.kwarg:
        out.append(a.kwarg)
    return out


def _last_name(fname: str) -> str:
    return fname.split(".")[-1]


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return bool(_HOST_ANN_RE.search(text)) and "Tensor" not in text


def param_taint(fn: ast.FunctionDef) -> Set[str]:
    """Initial tainted-name set: parameters that may hold tensors."""
    return {arg.arg for arg in _all_args(fn)
            if arg.arg not in ("self", "cls") and
            not _host_annotation(arg.annotation)}


def is_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _SHAPE_ATTRS:
            return False
        return is_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        fname = dotted(node.func)
        if fname in _UNTAINT_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_READS | _SHAPE_METHODS:
            return False
        if isinstance(node.func, ast.Attribute) and \
                is_tainted(node.func.value, tainted):
            return True          # method on a tensor -> tensor
        return any(is_tainted(a, tainted) for a in node.args) or \
            any(is_tainted(k.value, tainted) for k in node.keywords)
    if isinstance(node, (ast.Constant, ast.Lambda)):
        return False
    return any(is_tainted(c, tainted) for c in ast.iter_child_nodes(node))


def _assign_targets(node: ast.AST) -> List[str]:
    names: List[str] = []
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                names.append(n.id)
    return names


def walk_statements(fn: ast.FunctionDef, tainted: Set[str], on_stmt) -> None:
    """Source-order statement walk with taint propagation. ``on_stmt`` is
    called with (stmt, tainted) *before* the statement's own assignment
    effects apply. Nested function bodies are skipped (they are analyzed
    as functions in their own right)."""

    def walk(body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            on_stmt(stmt, tainted)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                value = stmt.value
                if value is not None:
                    # a local annotated as a python scalar/config is a
                    # host value, as such a parameter is
                    t = is_tainted(value, tainted) and not (
                        isinstance(stmt, ast.AnnAssign) and
                        _host_annotation(stmt.annotation))
                    for name in _assign_targets(stmt):
                        (tainted.add if t else tainted.discard)(name)
            elif isinstance(stmt, ast.AugAssign):
                if is_tainted(stmt.value, tainted):
                    for name in _assign_targets(stmt):
                        tainted.add(name)
            elif isinstance(stmt, ast.For):
                t = is_tainted(stmt.iter, tainted)
                for n in ast.walk(stmt.target):
                    if isinstance(n, ast.Name):
                        (tainted.add if t else tainted.discard)(n.id)
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, (ast.While, ast.If)):
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.With):
                walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body)
                for h in stmt.handlers:
                    walk(h.body)
                walk(stmt.orelse)
                walk(stmt.finalbody)

    walk(fn.body)


def _stmt_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Expression subtrees of one statement, excluding nested suites (those
    are walked as their own statements) and nested function bodies."""
    if isinstance(stmt, ast.Assign):
        yield stmt.value
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        if stmt.value is not None:
            yield stmt.value
    elif isinstance(stmt, (ast.Expr, ast.Return)):
        if stmt.value is not None:
            yield stmt.value
    elif isinstance(stmt, (ast.If, ast.While)):
        yield stmt.test
    elif isinstance(stmt, ast.For):
        yield stmt.iter
    elif isinstance(stmt, ast.With):
        for item in stmt.items:
            yield item.context_expr
    elif isinstance(stmt, ast.Assert):
        yield stmt.test
    elif isinstance(stmt, ast.Raise):
        if stmt.exc is not None:
            yield stmt.exc


# ==========================================================================
# R001 — host sync in device-reachable code
# ==========================================================================
class HostSyncRule(Rule):
    """A device -> host read of a value that flows from a tensor argument,
    inside a function reachable from a device seed (``callgraph.py``):
    ``int()``/``float()``/``bool()``, ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` and ``np.asarray()`` and friends (the
    reference's list, with torch's copies to the host), an ``if``/
    ``while``/``assert`` on ``x.any()``/``x.all()`` (an implicit
    ``bool()``), and the ops whose output shape depends on the data,
    ``.nonzero()``/``torch.nonzero``, ``masked_select`` and ``unique``: on the card each waits for every
    kernel queued before it, so the host cannot run ahead of the card. In
    host code they are fine — which is why the rule is scoped by the call
    graph instead of firing on every cast."""

    id = "R001"
    title = "host sync in device-reachable code"
    contract = ("code that runs once per forward or step keeps tensors on "
                "the card: no int()/.item()/.cpu()/nonzero on values flowing "
                "from tensor args, beyond the reasoned syncs a tick pays")

    _CASTS = {"int", "float", "bool", "complex"}
    _READS = {"item", "tolist", "cpu", "numpy"}
    _DATA_SHAPED = {"nonzero", "masked_select", "unique"}
    _NP_FNS = {"asarray", "array", "copy", "ascontiguousarray"}

    def check(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        graph = ctx.graph
        walker = graph.walkers.get(src.module)
        np_aliases = {"numpy"} | {
            a for a, m in (walker.mod_alias.items() if walker else ())
            if m == "numpy"}
        torch_aliases = {"torch"} | {
            a for a, m in (walker.mod_alias.items() if walker else ())
            if m == "torch"}
        for fn in iter_functions(src.tree):
            if not graph.is_reachable(fn):
                continue
            yield from self._check_fn(src, fn, np_aliases, torch_aliases)

    def _check_fn(self, src: SourceFile, fn: ast.FunctionDef,
                  np_aliases: Set[str], torch_aliases: Set[str]
                  ) -> Iterator[Finding]:
        found: List[Finding] = []

        def on_stmt(stmt: ast.stmt, tainted: Set[str]) -> None:
            if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                for red in self._truth_reductions(stmt.test, tainted):
                    found.append(self.finding(
                        src, red,
                        f"truth test of `{ast.unparse(red)[:40]}` forces a "
                        f"device sync in device-reachable `{fn.name}`",
                        fixit=("fold the condition into the result "
                               "(torch.where) or check it in host code")))
            for expr in _stmt_exprs(stmt):
                for call in ast.walk(expr):
                    if not isinstance(call, ast.Call):
                        continue
                    msg = self._violation(call, tainted, np_aliases,
                                          torch_aliases)
                    if msg:
                        found.append(self.finding(
                            src, call,
                            f"{msg} in device-reachable `{fn.name}`",
                            fixit=("keep the value on the card (torch.where, "
                                   "masks, fixed shapes) or move the read into "
                                   "host code outside the forward")))

        walk_statements(fn, param_taint(fn), on_stmt)
        yield from found

    @staticmethod
    def _truth_reductions(test: ast.AST, tainted: Set[str]
                          ) -> Iterator[ast.Call]:
        """``x.any()``/``x.all()`` of a tensor value that an ``if``/
        ``while``/``assert`` test (or an ``and``/``or``/``not`` operand of
        one) turns into a python bool."""
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                yield from HostSyncRule._truth_reductions(v, tainted)
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            yield from HostSyncRule._truth_reductions(test.operand, tainted)
        elif isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
                and test.func.attr in ("any", "all") and \
                is_tainted(test.func.value, tainted):
            yield test

    def _violation(self, call: ast.Call, tainted: Set[str],
                   np_aliases: Set[str], torch_aliases: Set[str]
                   ) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name) and f.id in self._CASTS:
            if any(is_tainted(a, tainted) for a in call.args):
                return (f"`{f.id}()` forces a device sync on tensor value "
                        f"`{ast.unparse(call.args[0])}`")
        if isinstance(f, ast.Attribute) and \
                f.attr in self._READS | self._DATA_SHAPED and \
                is_tainted(f.value, tainted):
            kind = ("forces a device sync on" if f.attr in self._READS else
                    "sizes its output by the data of")
            return f"`.{f.attr}()` {kind} tensor value `{ast.unparse(f.value)}`"
        name = dotted(f) or ""
        parts = name.split(".")
        if len(parts) == 2 and parts[0] in np_aliases and \
                parts[1] in self._NP_FNS:
            if any(is_tainted(a, tainted) for a in call.args):
                return (f"`{name}()` copies tensor value "
                        f"`{ast.unparse(call.args[0])}` to the host")
        if len(parts) == 2 and parts[0] in torch_aliases and \
                parts[1] in self._DATA_SHAPED and \
                any(is_tainted(a, tainted) for a in call.args):
            return (f"`{name}()` sizes its output by the data of tensor "
                    f"value `{ast.unparse(call.args[0])}`")
        return None


# ==========================================================================
# R003 — masked cache writes
# ==========================================================================
class MaskedScatterRule(Rule):
    """In ``models/``/``serving/``, a write into a KV cache or block pool
    (a base whose text matches the reference's ``cache|pool|kv``) must take
    its indices from a masked target. A write is an index assignment
    ``BASE[IDX] = v`` or ``BASE.index_put_/index_copy_/scatter_(...)``.
    Torch has no scatter with ``mode="drop"``, so the port drops dead rows
    and padding tokens by filtering the indices before the write: an index
    counts as masked when it comes from ``_paged_targets``/``_row_targets``
    (any ``*_targets`` call, or a parameter named ``targets``), from a
    ``torch.where``, or from a name or expression assigned from one of
    those. Not writes: a store of a dict entry (``cache["k"] = ...``, or
    any store into a name annotated ``dict``/``Dict``/``Params``) and a
    write whose index holds only slices and constants, the shared-position
    slice write that is the reference's ``dynamic_update_slice``. Without
    the mask a dead or stalled row's cache is clobbered."""

    id = "R003"
    title = "masked cache-write contract"
    contract = ("cache/pool writes take their indices from a masked target: "
                "_paged_targets/_row_targets or torch.where")

    _CACHEISH_RE = re.compile(r"cache|pool|\bkv\b", re.IGNORECASE)
    _WRITE_METHODS = {"index_put_", "index_copy_", "scatter_"}
    _DICT_ANN_RE = re.compile(r"\b(dict|Dict|Params)\b")

    def check(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        if not src.module.startswith(("repro_torch.models",
                                      "repro_torch.serving")) and \
                "/models/" not in src.path and "/serving/" not in src.path:
            return
        for fn in self._outermost_functions(src.tree):
            guarded = self._masked_exprs(fn)
            dicts = self._dict_params(fn)
            for node in ast.walk(fn):
                w = self._write(node, dicts)
                if w is None:
                    continue
                base, idx, anchor = w
                if not self._CACHEISH_RE.search(ast.unparse(base)):
                    continue
                if self._is_mask_source(idx, guarded):
                    continue
                yield self.finding(
                    src, anchor,
                    f"unguarded cache write into `{ast.unparse(base)[:40]}`: "
                    f"index `{ast.unparse(idx)[:40]}` is not routed through "
                    "a masked target",
                    fixit=("take the indices from _paged_targets/_row_targets "
                           "(dead rows filtered out) or torch.where(active, "
                           "idx, OOB)"))

    @staticmethod
    def _outermost_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
        """Functions not nested in another function: a nested write (a
        closure such as ``_ring_attention``'s ``write``) is checked with
        its enclosing function's names, once."""
        def rec(node, inside):
            for child in ast.iter_child_nodes(node):
                is_fn = isinstance(child, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                if is_fn and not inside:
                    yield child
                yield from rec(child, inside or is_fn)
        yield from rec(tree, False)

    @classmethod
    def _dict_params(cls, fn: ast.FunctionDef) -> Set[str]:
        out = set()
        for f in ast.walk(fn):
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out |= {a.arg for a in _all_args(f) if a.annotation is not None
                        and cls._DICT_ANN_RE.search(ast.unparse(a.annotation))}
        return out

    @classmethod
    def _write(cls, node: ast.AST, dicts: Set[str]
               ) -> Optional[Tuple[ast.AST, ast.AST, ast.AST]]:
        """(base, index, anchor) of a tensor write, else None."""
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Subscript):
                    continue
                if isinstance(t.value, ast.Name) and t.value.id in dicts:
                    continue
                elts = t.slice.elts if isinstance(t.slice, ast.Tuple) \
                    else [t.slice]
                if all(isinstance(e, (ast.Slice, ast.Constant)) for e in elts):
                    continue
                return t.value, t.slice, node
            return None
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in cls._WRITE_METHODS:
            at = 0 if node.func.attr == "index_put_" else 1
            if len(node.args) <= at:
                return None
            return node.func.value, node.args[at], node
        return None

    @staticmethod
    def _is_mask_source(node: ast.AST, guarded: Set[str]) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                last = _last_name(dotted(n.func) or "")
                if last == "where" or last.endswith("_targets"):
                    return True
            if isinstance(n, (ast.Name, ast.Attribute, ast.Subscript)) and \
                    ast.unparse(n) in guarded:
                return True
        return False

    @classmethod
    def _masked_exprs(cls, fn: ast.FunctionDef) -> Set[str]:
        """Texts of the names and expressions that hold masked indices, to
        a fixed point over the function (nested defs included)."""
        guarded = {a.arg for f in ast.walk(fn)
                   if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for a in _all_args(f)
                   if a.arg == "targets" or a.arg.endswith("_targets")}
        assigns = [s for s in ast.walk(fn)
                   if isinstance(s, ast.Assign) and s.value is not None]
        while True:
            before = len(guarded)
            for s in assigns:
                if cls._is_mask_source(s.value, guarded):
                    for t in s.targets:
                        guarded.add(ast.unparse(t))
                        guarded.update(n.id for n in ast.walk(t)
                                       if isinstance(n, ast.Name))
            if len(guarded) == before:
                return guarded


# ==========================================================================
# R004 — key discipline of repro_torch.random
# ==========================================================================
class PrngReuseRule(Rule):
    """A key of ``repro_torch.random`` (threefry, JAX's bits) consumed by
    two draws (``uniform``, ``randint``, ``gumbel``, ``categorical``,
    ``random_bits``) without an interleaving ``split``/``fold_in``/
    ``PRNGKey`` produces *correlated* samples — the batcher's
    slot/batch/backend-invariant sampling depends on every draw being
    keyed exactly once (``fold_in(request_key, position)``). Also flags a
    draw inside a loop whose body never re-derives the key: every
    iteration would sample the same stream. A draw is a call that resolves
    to one of those functions of ``repro_torch.random`` (through ``from
    repro_torch.random import ...``, a module alias, or inside that module
    itself)."""

    id = "R004"
    title = "PRNG key reuse"
    contract = ("a key feeds exactly one repro_torch.random draw; derive "
                "fresh keys with split/fold_in (position-keyed in serving)")

    _MODULE = "repro_torch.random"
    _DRAWS = {"uniform", "randint", "gumbel", "categorical", "random_bits"}
    _DERIVE = {"split", "fold_in", "PRNGKey", "clone"}

    def check(self, src: SourceFile, ctx: LintContext) -> Iterator[Finding]:
        walker = ctx.graph.walkers.get(src.module)
        for fn in iter_functions(src.tree):
            yield from self._check_fn(src, fn, walker)

    def _is_draw(self, call: ast.Call, walker) -> bool:
        text = dotted(call.func)
        if not text or walker is None:
            return False
        if "." in text:
            key = walker.resolve_dotted(text)
        else:
            key = walker.resolve(text)
            if key is None and walker.module == self._MODULE:
                key = f"{self._MODULE}:{text}"
        if key is None:
            return False
        module, _, name = key.partition(":")
        return module == self._MODULE and name in self._DRAWS

    def _is_derive(self, node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and \
                    _last_name(dotted(n.func) or "") in self._DERIVE:
                return True
        return False

    def _check_fn(self, src: SourceFile, fn: ast.FunctionDef,
                  walker) -> Iterator[Finding]:
        draws: List[Tuple[int, str, ast.Call]] = []
        rebinds: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                continue
            if isinstance(node, ast.Call) and self._is_draw(node, walker) and \
                    node.args and isinstance(node.args[0], ast.Name):
                draws.append((node.lineno, node.args[0].id, node))
            if isinstance(node, ast.Assign) and node.value is not None and \
                    self._is_derive(node.value):
                for name in _assign_targets(node):
                    rebinds.setdefault(name, []).append(node.lineno)

        # straight-line double consumption
        draws.sort(key=lambda d: (d[0], d[2].col_offset))
        last_use: Dict[str, int] = {}
        for line, name, node in draws:
            prev = last_use.get(name)
            if prev is not None and not any(
                    prev < ln <= line for ln in rebinds.get(name, [])):
                yield self.finding(
                    src, node,
                    f"key `{name}` already consumed by a draw at line {prev} "
                    "and reused without split/fold_in — the two draws are "
                    "correlated",
                    fixit=f"derive a fresh key first: `{name}, sub = "
                          f"split({name})` (or fold_in a position for "
                          "serving-invariant sampling)")
            last_use[name] = line

        # draw inside a loop with no per-iteration derivation
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            lo, hi = loop.lineno, loop.end_lineno or loop.lineno
            loop_targets = set()
            if isinstance(loop, ast.For):
                loop_targets = {n.id for n in ast.walk(loop.target)
                                if isinstance(n, ast.Name)}
            for line, name, node in draws:
                if not (lo <= line <= hi) or name in loop_targets:
                    continue
                if not any(lo <= ln <= hi for ln in rebinds.get(name, [])):
                    yield self.finding(
                        src, node,
                        f"key `{name}` is drawn from inside a loop but never "
                        "re-derived per iteration — every iteration samples "
                        "the same stream",
                        fixit=f"fold the loop index in: `k = fold_in({name}, "
                              "i)` before the draw")


ALL_RULES = [HostSyncRule, MaskedScatterRule, PrngReuseRule]
