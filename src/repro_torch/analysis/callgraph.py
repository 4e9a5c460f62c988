"""Lightweight device call graph over the linted files (port of
``repro.analysis.callgraph``).

R001 (host sync) must know whether a function runs once per forward or
per step on the card. The port runs eagerly: it has no ``jax.jit`` and no
``pallas_call`` to seed the graph from, so the seeds are the functions
that do the per-forward work, chosen by a written rule:

  * **Seeds**
      - the dotted names in ``DEVICE_SEEDS`` (``module:qualname``):
        ``model_apply``, the batcher tick's ``step_rows_full`` and
        ``sample_rows``, and the step function ``make_train_step``
        returns;
      - ``forward`` and ``backward`` of every class that derives from
        ``torch.autograd.Function`` (``FlashAttention``);
      - every function that calls a C entry point of ``csrc/*.cu``. Those
        are named ``<kernel>_launch`` and are called as an attribute of
        the ctypes library (``_kernel_lib().paged_attention_launch(...)``,
        ``lib.int8_matmul_launch(...)``): the kernel wrappers of
        ``kernels/*.py``.

    The port's model code carries no decorator or marker for this.
  * **Edges** — inside a function body, every ``Name`` that resolves to a
    function visible in scope (enclosing defs, module-level defs, or a
    ``from repro_torch.x import fn`` import) adds an edge, and so does an
    attribute ``m.fn`` of an imported module (``import repro_torch.x as
    m``, ``from repro_torch import x``). Resolving *references* rather
    than just direct calls keeps closure-passing idioms in the graph. A
    class resolves to its ``__init__``, and a name a package ``__init__``
    re-exports to its definition.
  * **Reachable** — the closure of the seeds over those edges. Host-side
    code (the scheduler's slot bookkeeping, calibration loops) that
    merely *calls* the tick is not reachable.

Known blind spot, by design and as in the reference: method calls
through objects (``self._step_fn(...)``, ``ctx.act(...)``,
``FlashAttention.apply(...)``) are not resolved; resolving them would
need type inference for little gain here. That is why the
``autograd.Function`` methods are seeds of their own.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.engine import SourceFile

# functions that run once per forward or per step on the card
DEVICE_SEEDS = (
    "repro_torch.models.transformer:model_apply",
    "repro_torch.serving.decode:step_rows_full",
    "repro_torch.serving.decode:sample_rows",
    "repro_torch.train.step:make_train_step.train_step",
)
_AUTOGRAD_BASES = {"torch.autograd.Function", "torch.autograd.function.Function"}
_AUTOGRAD_METHODS = {"forward", "backward"}


def dotted(node: ast.AST) -> Optional[str]:
    """Textual dotted path of a Name/Attribute chain ('torch.nonzero'),
    else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    key: str                       # "module:qualname"
    module: str
    qualname: str
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    refs: Set[str] = dataclasses.field(default_factory=set)
    seed: Optional[str] = None     # None | "listed" | "autograd" | "kernel"


class _ModuleWalker(ast.NodeVisitor):
    """Collect functions, import aliases, references and seeds of one
    module, with lexical scoping for nested defs."""

    def __init__(self, src: SourceFile, graph: "CallGraph"):
        self.src = src
        self.graph = graph
        self.module = src.module
        # import alias tables
        self.mod_alias: Dict[str, str] = {}    # local name -> module path
        self.sym_alias: Dict[str, str] = {}    # local name -> "module:sym"
        # scope stack: list of {local fn name -> key}
        self.scopes: List[Dict[str, str]] = [{}]
        self.qual: List[str] = []
        self.fn_stack: List[FunctionInfo] = []
        # (derives from autograd.Function, depth of fn_stack at the class)
        self.classes: List[tuple] = []
        self._prescan_imports(src.tree)
        self._collect(src.tree)

    # -- imports ---------------------------------------------------------
    def _prescan_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.sym_alias[a.asname or a.name] = (
                        f"{node.module}:{a.name}")

    # -- collection ------------------------------------------------------
    def _collect(self, node: ast.AST) -> None:
        """Two passes per scope body: register defs first (so forward
        references and mutual recursion resolve), then walk bodies."""
        body = node.body if hasattr(node, "body") else []
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register(stmt)
            elif isinstance(stmt, ast.ClassDef):
                # a reference to a class runs its __init__ when called
                self.scopes[-1][stmt.name] = \
                    f"{self.module}:{'.'.join(self.qual + [stmt.name])}"
        for stmt in body:
            self.visit(stmt)

    def _register(self, node: ast.AST) -> str:
        name = node.name
        qual = ".".join(self.qual + [name])
        key = f"{self.module}:{qual}"
        if key not in self.graph.functions:
            self.graph.functions[key] = FunctionInfo(
                key=key, module=self.module, qualname=qual, node=node)
        self.scopes[-1][name] = key
        return key

    def resolve(self, name: str) -> Optional[str]:
        """Resolve a bare name to a function key through the scope stack,
        then through ``from x import f`` aliases."""
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return self.sym_alias.get(name)

    def module_of(self, text: str) -> Optional[str]:
        """The module a dotted prefix names ('m', 'repro_torch.x'), if its
        root is an imported module or a symbol imported from a package."""
        root, _, rest = text.partition(".")
        if root in self.mod_alias:
            base = self.mod_alias[root]
        elif root in self.sym_alias:
            base = self.sym_alias[root].replace(":", ".")
        else:
            return None
        return f"{base}.{rest}" if rest else base

    def resolve_dotted(self, text: str) -> Optional[str]:
        """Resolve 'alias.fn' where alias is an imported module."""
        if "." not in text:
            return self.resolve(text)
        prefix, _, last = text.rpartition(".")
        mod = self.module_of(prefix)
        return f"{mod}:{last}" if mod is not None else None

    def canonical(self, text: Optional[str]) -> Optional[str]:
        """Expand the leading import alias of a dotted path ('autograd.
        Function' -> 'torch.autograd.Function')."""
        if not text:
            return text
        root, _, rest = text.partition(".")
        mod = self.mod_alias.get(root)
        if mod and rest:
            return f"{mod}.{rest}"
        sym = self.sym_alias.get(root)
        if sym:
            full = sym.replace(":", ".")
            return f"{full}.{rest}" if rest else full
        return text

    # -- visitors --------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        for b in node.bases:
            self.visit(b)
        autograd = any(self.canonical(dotted(b)) in _AUTOGRAD_BASES
                       for b in node.bases)
        self.qual.append(node.name)
        self.scopes.append({})
        self.classes.append((autograd, len(self.fn_stack)))
        self._collect(node)
        self.classes.pop()
        self.scopes.pop()
        self.qual.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_def(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_def(node)

    def _visit_def(self, node) -> None:
        key = self.scopes[-1].get(node.name) or self._register(node)
        info = self.graph.functions[key]
        method_of = self.classes[-1] if self.classes and \
            self.classes[-1][1] == len(self.fn_stack) else None
        if method_of is not None and method_of[0] and \
                node.name in _AUTOGRAD_METHODS:
            info.seed = "autograd"
        elif key in self.graph.seed_names:
            info.seed = "listed"
        for d in node.decorator_list:
            self.visit(d)
        self.qual.append(node.name)
        self.scopes.append({})
        self.fn_stack.append(info)
        self._collect(node)
        self.fn_stack.pop()
        self.scopes.pop()
        self.qual.pop()

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and self.fn_stack:
            key = self.resolve(node.id)
            if key is not None:
                self.fn_stack[-1].refs.add(key)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load) and self.fn_stack:
            text = dotted(node)
            key = self.resolve_dotted(text) if text else None
            if key is not None:
                self.fn_stack[-1].refs.add(key)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if self.fn_stack and isinstance(f, ast.Attribute) and \
                f.attr.endswith("_launch") and \
                self.module_of(dotted(f.value) or "") is None:
            # a C entry point called on the ctypes library: a kernel wrapper
            self.fn_stack[-1].seed = self.fn_stack[-1].seed or "kernel"
        self.generic_visit(node)


class CallGraph:
    """Build once per lint run; exposes device-reachability."""

    def __init__(self, files: Sequence[SourceFile]):
        self.functions: Dict[str, FunctionInfo] = {}
        self.seed_names = set(DEVICE_SEEDS)
        self.walkers: Dict[str, _ModuleWalker] = {}
        for src in files:
            self.walkers[src.module] = _ModuleWalker(src, self)
        self.reachable: Set[str] = self._closure()
        self._reachable_nodes = {
            id(self.functions[k].node) for k in self.reachable}

    def defined(self, key: str) -> Optional[str]:
        """``key`` itself, the ``__init__`` of a class ``key`` names, or the
        definition a package re-exports under it
        (``repro_torch.models:model_apply`` -> ``...transformer:...``)."""
        seen = set()
        while key not in self.functions and key not in seen:
            seen.add(key)
            if key + ".__init__" in self.functions:
                return key + ".__init__"
            module, _, name = key.partition(":")
            walker = self.walkers.get(module)
            if walker is None or name not in walker.sym_alias:
                return None
            key = walker.sym_alias[name]
        return key if key in self.functions else None

    def _closure(self) -> Set[str]:
        seen: Set[str] = set()
        frontier = [k for k, f in self.functions.items() if f.seed]
        while frontier:
            k = self.defined(frontier.pop())
            if k is None or k in seen:
                continue
            seen.add(k)
            frontier.extend(self.functions[k].refs - seen)
        return seen

    def is_reachable(self, node: ast.AST) -> bool:
        """True if this FunctionDef node can run once per forward or step."""
        return id(node) in self._reachable_nodes
