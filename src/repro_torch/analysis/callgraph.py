"""Lightweight per-module call graph: which functions run inside a
captured or transformed step?

The host-sync rule needs to know whether a function's body runs inside a
CUDA-graph capture or a ``torch.func`` transform, because a host read
(``.item()``, ``float()``, a boolean-mask index, ``torch.tensor`` of host
data) is a hazard there: a capture refuses it, and on the CPU it would
read the device once a step where the card's replay cannot. Full
interprocedural analysis is out of scope; this module computes a
deliberately simple approximation that is accurate for the port's idioms:

* **roots** — functions passed by name to a step registry
  (``graphs.add("round", round_fn, ...)`` of a
  ``federated/replay.py::StepGraphs``), functions with the step protocol's
  signature ``fn(carry, ctr)`` (the fused engines hand theirs to
  ``graphs.add`` through a factory's tuple, ``steps[0]``), functions whose
  name is passed to a transform (``torch.func.vmap``, ``grad``,
  ``grad_and_value``, ``functional_call``,
  ``torch.utils.checkpoint.checkpoint``), the ``forward`` and ``backward``
  of a ``torch.autograd.Function``, and the body of a ``with
  torch.cuda.graph(...)`` block (with what it calls).
* **edges** — a call (or function-reference argument) to a bare name, or
  to ``self.<name>``, that matches another function defined in the same
  module. Matching is by name, which also resolves factory closures (a
  caller that does ``step = make_round_engine(...)`` then calls
  ``step(...)`` lands on the factory's inner ``def step``).
* **nesting** — a function lexically nested inside a captured function is
  captured (its body runs while the parent runs).

The result is the set of FunctionDef nodes considered captured, with a
human-readable reason per node for the finding message, and the
``with torch.cuda.graph(...)`` blocks themselves.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.engine import dotted_name, iter_functions, own_nodes

#: call targets whose function-valued arguments run transformed
_TRANSFORMS = {
    "torch.func.vmap", "torch.vmap", "vmap", "func.vmap",
    "torch.func.grad", "grad", "func.grad",
    "torch.func.grad_and_value", "grad_and_value", "func.grad_and_value",
    "torch.func.functional_call", "functional_call",
    "func.functional_call",
    "torch.utils.checkpoint.checkpoint", "checkpoint",
}
#: a ``with`` item that opens a CUDA-graph capture
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
#: base classes whose forward/backward run under autograd's transforms
_AUTOGRAD_FUNCTIONS = {"torch.autograd.Function", "autograd.Function",
                       "Function"}
#: the step protocol of ``federated/replay.py``: ``fn(carry, ctr)``
_STEP_SIGNATURE = ("carry", "ctr")


def _param_names(fn: ast.AST) -> Tuple[str, ...]:
    args = fn.args
    return tuple(a.arg for a in args.posonlyargs + args.args)


def _callee_names(call: ast.Call) -> List[str]:
    """Names a call resolves to: ``f`` for ``f(...)``, and ``m`` for
    ``self.m(...)``."""
    name = dotted_name(call.func)
    if name is None:
        return []
    if name.startswith("self.") and name.count(".") == 1:
        return [name, name.split(".", 1)[1]]
    return [name]


class CapturedGraph:
    """Captured reachability over one module's function defs."""

    def __init__(self, tree: ast.Module):
        self.functions: List[ast.AST] = list(iter_functions(tree))
        self.by_name: Dict[str, List[ast.AST]] = {}
        for fn in self.functions:
            self.by_name.setdefault(fn.name, []).append(fn)

        self._parent: Dict[ast.AST, ast.AST] = {}
        for fn in self.functions:
            for child in own_nodes(fn):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    self._parent[child] = fn

        self.reason: Dict[ast.AST, str] = {}
        #: (with-node, enclosing function or None) of each graph capture
        self.blocks: List[Tuple[ast.With, Optional[ast.AST]]] = []
        self._mark_roots(tree)
        self._propagate()

    # -- construction -----------------------------------------------------

    def _mark(self, fn: ast.AST, reason: str) -> None:
        if fn not in self.reason:
            self.reason[fn] = reason

    def _mark_names(self, names, reason: str) -> None:
        for name in names:
            for fn in self.by_name.get(name, []):
                self._mark(fn, reason)

    def _mark_roots(self, tree: ast.Module) -> None:
        for fn in self.functions:
            if _param_names(fn) == _STEP_SIGNATURE:
                self._mark(fn, "a step fn(carry, ctr)")
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and any(
                    dotted_name(b) in _AUTOGRAD_FUNCTIONS
                    for b in node.bases):
                for stmt in node.body:
                    if (isinstance(stmt, ast.FunctionDef)
                            and stmt.name in ("forward", "backward")):
                        self._mark(stmt, f"{node.name}.{stmt.name} of a "
                                         f"torch.autograd.Function")
            elif isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                if callee in _TRANSFORMS:
                    for arg in list(node.args) + [kw.value
                                                  for kw in node.keywords]:
                        name = dotted_name(arg)
                        if name in self.by_name:
                            self._mark_names([name], f"passed to {callee}")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "add" and len(node.args) >= 2
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    name = dotted_name(node.args[1])
                    if name in self.by_name:
                        self._mark_names([name],
                                         f"a step of {callee}(...)")
            elif isinstance(node, ast.With) and any(
                    isinstance(item.context_expr, ast.Call)
                    and dotted_name(item.context_expr.func)
                    in _GRAPH_CONTEXTS for item in node.items):
                self.blocks.append((node, self._enclosing(node)))
        for block, _ in self.blocks:
            self._mark_names(self._block_calls(block),
                             "called inside a torch.cuda.graph capture")

    def _enclosing(self, node: ast.AST) -> Optional[ast.AST]:
        for fn in self.functions:
            if any(n is node for n in own_nodes(fn)):
                return fn
        return None

    @staticmethod
    def _block_calls(block: ast.With) -> Set[str]:
        out: Set[str] = set()
        for stmt in block.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    out.update(_callee_names(node))
        return out

    def _calls_out(self, fn: ast.AST) -> Set[str]:
        """Names this function calls or passes onward (own scope only)."""
        out: Set[str] = set()
        for node in own_nodes(fn):
            if isinstance(node, ast.Call):
                out.update(_callee_names(node))
                for arg in (list(node.args)
                            + [kw.value for kw in node.keywords]):
                    ref = dotted_name(arg)
                    if ref:
                        out.add(ref)
        return out

    def _propagate(self) -> None:
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                if fn in self.reason:
                    continue
                parent = self._parent.get(fn)
                if parent is not None and parent in self.reason:
                    self._mark(fn, f"nested in captured '{parent.name}'")
                    changed = True
            for fn in list(self.reason):
                for callee in self._calls_out(fn):
                    for target in self.by_name.get(callee, []):
                        if target not in self.reason:
                            self._mark(target,
                                       f"called from captured '{fn.name}'")
                            changed = True

    # -- queries ----------------------------------------------------------

    def captured_functions(self) -> List[Tuple[ast.AST, str]]:
        return [(fn, self.reason[fn]) for fn in self.functions
                if fn in self.reason]
