"""PyTorch-hazard lint rules for the port, one for each rule of the JAX
package's lint (``repro.analysis.rules``), each derived from a real bug
class of this project's history.

PT101 prng-key-reuse             — JX101, the recharge-RNG class
PT102 optional-knob-truthiness   — JX102, the ``deadline_s=0.0`` class
PT103 host-sync-in-captured      — JX103, host reads in a captured step
PT104 arg-mutation               — JX104, the overcommit mutation class
PT105 nondeterminism             — JX105, wall clock / global RNG
PT106 live-carry-read-after-run  — JX106, the port's donated buffer

Rules are pure-``ast`` visitors over
:class:`repro_torch.analysis.engine.Module` with a shared
:class:`~repro_torch.analysis.engine.ProjectIndex`. Each yields
:class:`~repro_torch.analysis.engine.Finding`s; suppression happens in
the engine via the baseline file, never inside a rule.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import CapturedGraph
from repro_torch.analysis.engine import (
    Finding,
    Module,
    ProjectIndex,
    annotation_text,
    dotted_name,
    is_optional_numeric,
    iter_functions,
    node_end,
    node_pos,
    own_nodes,
    root_name,
)

#: modules that own deterministic engine state — scope for PT104/PT105
ENGINE_SCOPE = ("federated/", "core/", "checkpoint/", "kernels/",
                "compression/", "data/")


class Rule:
    id: str = ""
    name: str = ""
    summary: str = ""
    #: path fragments this rule is restricted to (None = everywhere)
    scope: Optional[Tuple[str, ...]] = None
    #: path fragments this rule never fires in
    exclude: Tuple[str, ...] = ()

    def applies_to(self, path: str) -> bool:
        p = path.replace("\\", "/")
        if any(frag in p for frag in self.exclude):
            return False
        if self.scope is None:
            return True
        return any(frag in p for frag in self.scope)

    def check(self, module: Module,
              project: ProjectIndex) -> Iterator[Finding]:
        raise NotImplementedError


# --------------------------------------------------------------- PT101


#: callees that *derive* a fresh key (consuming their argument safely):
#: the port's threefry (``prng.py``: ``PRNGKey``, ``split``, ``fold_in``)
_KEY_DERIVERS = {
    "prng.PRNGKey", "PRNGKey", "repro_torch.prng.PRNGKey",
    "prng.split", "split", "repro_torch.prng.split",
    "prng.fold_in", "fold_in", "repro_torch.prng.fold_in",
}


def _is_key_source(value: ast.AST) -> bool:
    """True when the assigned value manufactures PRNG key(s): a deriver's
    call, or a row or an ``unbind`` of one (``split(k, 4).unbind(-2)``)."""
    while True:
        if isinstance(value, ast.Subscript):
            value = value.value
        elif (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and isinstance(value.func.value, (ast.Call, ast.Subscript))):
            value = value.func.value
        else:
            break
    if isinstance(value, ast.Call):
        return dotted_name(value.func) in _KEY_DERIVERS
    return False


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _mark_subtree(node: ast.AST, path, paths) -> None:
    paths[node] = path
    if isinstance(node, ast.Lambda):
        return
    if isinstance(node, ast.IfExp):
        _mark_subtree(node.test, path, paths)
        _mark_subtree(node.body, path + ((id(node), 0),), paths)
        _mark_subtree(node.orelse, path + ((id(node), 1),), paths)
        return
    for c in ast.iter_child_nodes(node):
        _mark_subtree(c, path, paths)


def _assign_paths(stmts: Sequence[ast.stmt], path, paths) -> None:
    for i, node in enumerate(stmts):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        paths[node] = path
        if isinstance(node, ast.If):
            _mark_subtree(node.test, path, paths)
            _assign_paths(node.body, path + ((id(node), 0),), paths)
            _assign_paths(node.orelse, path + ((id(node), 1),), paths)
            if _terminates(node.body):
                # the body cannot fall through: everything after this If
                # runs only on its else side
                _assign_paths(stmts[i + 1:], path + ((id(node), 1),),
                              paths)
                return
        elif isinstance(node, ast.Try):
            _assign_paths(node.body, path + ((id(node), 0),), paths)
            for h in node.handlers:
                _assign_paths(h.body, path + ((id(node), 1),), paths)
            _assign_paths(node.orelse, path + ((id(node), 0),), paths)
            _assign_paths(node.finalbody, path, paths)
        else:
            for _, value in ast.iter_fields(node):
                if (isinstance(value, list) and value
                        and all(isinstance(v, ast.stmt) for v in value)):
                    _assign_paths(value, path, paths)
                elif isinstance(value, ast.AST):
                    _mark_subtree(value, path, paths)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.AST):
                            _mark_subtree(v, path, paths)


def branch_paths(fn: ast.AST) -> Dict[ast.AST, Tuple]:
    """node -> chain of (if-node-id, arm) from the function root, with
    statements after a non-falling-through ``if`` placed on its else
    arm. Two nodes are mutually exclusive iff they take different arms
    of some common ``if``."""
    paths: Dict[ast.AST, Tuple] = {}
    _assign_paths(fn.body, (), paths)
    return paths


def _exclusive(p1: Tuple, p2: Tuple) -> bool:
    arms = dict(p1)
    return any(n in arms and arms[n] != a for n, a in p2)


class PrngKeyReuse(Rule):
    id = "PT101"
    name = "prng-key-reuse"
    summary = ("a PRNG key variable is consumed by two calls without an "
               "intervening prng.split/fold_in — correlated randomness "
               "(JX101's counterpart: the recharge-RNG bug class)")
    # launch/ checkers replay ONE key stream into two engines on purpose
    # (bitwise parity comparison) — key sharing is their whole point
    exclude = ("launch/",)

    def check(self, module, project):
        for fn in iter_functions(module.tree):
            yield from self._check_function(module, fn)

    def _key_params(self, fn) -> Set[str]:
        args = fn.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        return {n for n in names
                if n in ("key", "rng") or n.endswith("key")}

    def _check_function(self, module, fn):
        paths = branch_paths(fn)
        # tracked key var -> list of prior consumptions (pos, path, line)
        tracked: Dict[str, List[Tuple]] = {
            n: [] for n in self._key_params(fn)}
        # events in source order: (pos, kind, payload)
        events = []
        for node in own_nodes(fn):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func) or ""
                derives = callee in _KEY_DERIVERS
                for arg in (list(node.args)
                            + [kw.value for kw in node.keywords]):
                    if isinstance(arg, ast.Name):
                        events.append((node_pos(arg), "consume",
                                       (arg.id, derives, arg, node)))
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = getattr(node, "value", None)
                names = []
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        names.extend(e.id for e in t.elts
                                     if isinstance(e, ast.Name))
                for n in names:
                    events.append((node_end(node), "assign",
                                   (n, value is not None
                                    and _is_key_source(value))))
        events.sort(key=lambda e: e[0])
        for pos, kind, payload in events:
            if kind == "assign":
                name, is_key = payload
                if is_key:
                    tracked[name] = []
                elif name in tracked:
                    del tracked[name]
            else:
                name, derives, arg, call = payload
                if name not in tracked or derives:
                    continue
                path = paths.get(arg, ())
                clash = next((c for c in tracked[name]
                              if not _exclusive(c[1], path)), None)
                if clash is None:
                    tracked[name].append((pos, path, pos[0]))
                else:
                    yield module.finding(
                        self.id, call,
                        f"PRNG key '{name}' is consumed again without an "
                        f"intervening split/fold_in (first consumed at "
                        f"line {clash[2]}) — the two draws are perfectly "
                        f"correlated")


# --------------------------------------------------------------- PT102


#: Optional numeric knobs whose PT102 coverage the test suite pins
#: (tests/test_torch_analysis.py): the JAX package's JX102 set, since the
#: port's FLConfig has the same knobs. These are the run-shaping knobs
#: where the 0-versus-None distinction has real semantics
#: (deadline_s=0.0 was the original bug; energy_budget_j=0.0 is "refuse
#: every cohort", not "unmetered") — a project scan of src/repro_torch
#: must index every one of them in ``ProjectIndex.optional_numeric_fields``,
#: so a refactor that drops an Optional annotation cannot silently blind
#: the rule.
PT102_REQUIRED_KNOBS = frozenset({
    "deadline_s",
    "sim_model_bytes",
    "sim_local_steps",
    "buffer_size",
    "max_concurrency",
    "checkpoint_every",
    "energy_budget_j",
    "snapshot_ring_size",
})


class OptionalKnobTruthiness(Rule):
    id = "PT102"
    name = "optional-knob-truthiness"
    summary = ("truthiness test on an Optional numeric knob — 0/0.0/False "
               "is a real value, not 'unset'; use 'is not None' "
               "(JX102's counterpart: the deadline_s=0.0 bug class)")

    def check(self, module, project):
        fields = project.optional_numeric_fields
        for fn in iter_functions(module.tree):
            opt_params = self._optional_params(fn)
            for expr in self._bool_contexts(fn):
                yield from self._check_expr(module, expr, fields,
                                            opt_params)
        # module-level boolean contexts (rare, but cheap to cover);
        # own_nodes() does not descend into the function defs already
        # handled above
        for expr in self._bool_contexts(module.tree):
            yield from self._check_expr(module, expr, fields, set())

    def _optional_params(self, fn) -> Set[str]:
        args = fn.args
        out = set()
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if is_optional_numeric(annotation_text(a.annotation)):
                out.add(a.arg)
        return out

    def _bool_contexts(self, scope):
        """Expressions evaluated for truthiness within ``scope`` (not
        descending into nested function scopes)."""
        seen = set()
        for node in own_nodes(scope):
            exprs = []
            if isinstance(node, (ast.If, ast.While)):
                exprs.append(node.test)
            elif isinstance(node, ast.IfExp):
                exprs.append(node.test)
            elif isinstance(node, ast.Assert):
                exprs.append(node.test)
            elif isinstance(node, ast.BoolOp):
                exprs.extend(node.values)
            elif (isinstance(node, ast.UnaryOp)
                    and isinstance(node.op, ast.Not)):
                exprs.append(node.operand)
            elif isinstance(node, ast.comprehension):
                exprs.extend(node.ifs)
            for e in exprs:
                k = (id(e),)
                if k not in seen:
                    seen.add(k)
                    yield e

    def _check_expr(self, module, expr, fields, opt_params):
        if isinstance(expr, ast.Attribute):
            if expr.attr in fields:
                yield module.finding(
                    self.id, expr,
                    f"truthiness test on '.{expr.attr}' which is declared "
                    f"{fields[expr.attr]} — 0/0.0/False is a real value "
                    f"that this treats as 'unset'; compare 'is not None'")
        elif isinstance(expr, ast.Name):
            if expr.id in opt_params:
                yield module.finding(
                    self.id, expr,
                    f"truthiness test on parameter '{expr.id}' annotated "
                    f"Optional numeric — 0/0.0/False is a real value that "
                    f"this treats as 'unset'; compare 'is not None'")


# --------------------------------------------------------------- PT103


#: method calls that read a device value on the host, or size their
#: output from the data
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu", "nonzero",
                 "masked_select"}
#: calls that size their output from the data
_DATA_SIZED = {"torch.nonzero", "torch.masked_select", "torch.argwhere"}
#: calls that make a tensor of host data (a copy a capture cannot hold)
_HOST_TENSORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
                 "torch.asarray"}
#: numpy attribute accesses that are NOT calls into numpy compute
_NP_BENIGN = {"float32", "float64", "float16", "int8", "int16", "int32",
              "int64", "uint8", "uint16", "uint32", "uint64", "bool_",
              "dtype", "ndarray", "errstate", "printoptions"}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
#: attributes and methods whose value is a tensor's metadata, not data
_META_ATTRS = {"shape", "ndim"}
_META_METHODS = {"numel", "dim", "size", "element_size"}


def _is_metadata(expr: ast.AST) -> bool:
    """True when ``expr`` is built only from constants and tensor
    metadata (``len(x)``, ``x.shape[0]``, ``x.ndim``, ``x.numel()``): a
    Python number on the host, never a read of the device."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Call):
        if dotted_name(expr.func) == "len":
            return True
        return (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _META_METHODS)
    if isinstance(expr, ast.Subscript):
        return (isinstance(expr.value, ast.Attribute)
                and expr.value.attr in _META_ATTRS)
    if isinstance(expr, ast.Attribute):
        return expr.attr in _META_ATTRS
    if isinstance(expr, ast.BinOp):
        return _is_metadata(expr.left) and _is_metadata(expr.right)
    if isinstance(expr, ast.UnaryOp):
        return _is_metadata(expr.operand)
    return False


def _is_mask(expr: ast.AST) -> bool:
    """A boolean mask written in place: a comparison, or ``&``/``|``/``~``
    of one."""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.BinOp) and isinstance(expr.op,
                                                  (ast.BitAnd, ast.BitOr)):
        return _is_mask(expr.left) or _is_mask(expr.right)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_mask(expr.operand)
    return False


def _block_nodes(block: ast.With):
    """The nodes of a ``with`` block's body, not descending into nested
    function definitions."""
    stack = list(block.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


class HostSyncInCaptured(Rule):
    id = "PT103"
    name = "host-sync-in-captured"
    summary = ("host read (.item()/.cpu()/float()/a boolean-mask index/"
               "torch.tensor of host data/np.*) inside a function reachable "
               "from a captured step or a torch.func transform — a CUDA "
               "graph cannot capture it, and eagerly it syncs every step "
               "(JX103's counterpart: host syncs under trace)")

    def check(self, module, project):
        graph = CapturedGraph(module.tree)
        for fn, why in graph.captured_functions():
            yield from self._check_nodes(module, own_nodes(fn),
                                         f"'{fn.name}'", why)
        for block, enclosing in graph.blocks:
            where = ("a torch.cuda.graph block" if enclosing is None else
                     f"the torch.cuda.graph block of '{enclosing.name}'")
            yield from self._check_nodes(module, _block_nodes(block), where,
                                         "captured")

    def _check_nodes(self, module, nodes, where, why):
        for node in nodes:
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _is_mask(node.slice)):
                yield module.finding(
                    self.id, node,
                    f"boolean-mask index inside {where} ({why}) sizes its "
                    f"output from the data — a host read; use "
                    f"torch.where or a fixed-size gather")
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func) or ""
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS):
                yield module.finding(
                    self.id, node,
                    f".{node.func.attr}() inside {where} ({why}) reads the "
                    f"device on the host")
            elif callee in _DATA_SIZED:
                yield module.finding(
                    self.id, node,
                    f"'{callee}' inside {where} ({why}) sizes its output "
                    f"from the data — a host read")
            elif callee in _HOST_TENSORS:
                yield module.finding(
                    self.id, node,
                    f"'{callee}' inside {where} ({why}) makes a tensor of "
                    f"host data — a host-to-device copy a capture cannot "
                    f"hold; make it once in set-up")
            elif callee.startswith("np.") or callee.startswith("numpy."):
                tail = callee.split(".", 1)[1]
                if tail.split(".")[0] not in _NP_BENIGN:
                    yield module.finding(
                        self.id, node,
                        f"numpy call '{callee}' inside {where} ({why}) "
                        f"computes on the host — use torch or hoist it "
                        f"out of the step")
            elif (callee in _CAST_BUILTINS and len(node.args) == 1
                    and not _is_metadata(node.args[0])):
                yield module.finding(
                    self.id, node,
                    f"{callee}() inside {where} ({why}) reads a tensor's "
                    f"value on the host (a sync a capture refuses)")


# --------------------------------------------------------------- PT104


_MUTATOR_METHODS = {"append", "extend", "insert", "remove", "clear",
                    "update", "setdefault", "popitem", "sort", "reverse",
                    "add", "discard", "fill", "setflags"}


def _is_inplace_method(attr: str) -> bool:
    """A PyTorch in-place tensor method: ``add_``, ``copy_``,
    ``index_copy_``, ``masked_fill_``, ... (one trailing underscore)."""
    return (attr.endswith("_") and not attr.startswith("_")
            and not attr.endswith("__"))


def _is_output_buffer(name: str) -> bool:
    """A kernel wrapper's own output buffer (``out``, ``out_idx``,
    ``lse_out``): written by design, as a Pallas kernel writes its refs."""
    return name == "out" or name.startswith("out_") or name.endswith("_out")


class ArgMutation(Rule):
    id = "PT104"
    name = "arg-mutation"
    summary = ("in-place mutation of a function argument in engine code "
               "(an in-place tensor method, subscript assignment or out=) "
               "— callers share the tensor; clone it or return a new "
               "value (JX104's counterpart: the overcommit mutation bug "
               "class)")
    scope = ENGINE_SCOPE

    def check(self, module, project):
        for fn in iter_functions(module.tree):
            params = self._params(fn)
            if params:
                yield from self._check_body(module, fn, params)

    def _params(self, fn) -> Set[str]:
        args = fn.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if getattr(args, "vararg", None):
            names.append(args.vararg.arg)
        if getattr(args, "kwarg", None):
            names.append(args.kwarg.arg)
        return {n for n in names
                if n not in ("self", "cls") and not _is_output_buffer(n)}

    def _rebind_positions(self, fn, params) -> Dict[str, Tuple[int, int]]:
        """Earliest bare-name rebinding of each param (``x = x.clone()``):
        later writes hit the local copy, not the caller's tensor."""
        out: Dict[str, Tuple[int, int]] = {}
        for node in own_nodes(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.For)):
                targets = [node.target]
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets = [node.optional_vars]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for e in elts:
                    if isinstance(e, ast.Name) and e.id in params:
                        pos = node_pos(e)
                        if e.id not in out or pos < out[e.id]:
                            out[e.id] = pos
        return out

    def _check_body(self, module, fn, params):
        rebound = self._rebind_positions(fn, params)

        def still_param(base, node) -> bool:
            return (base in params
                    and (base not in rebound
                         or node_pos(node) <= rebound[base]))

        for node in own_nodes(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        elts = t.elts
                    else:
                        elts = [t]
                    for e in elts:
                        if isinstance(e, (ast.Subscript, ast.Attribute)):
                            base = root_name(e)
                            if still_param(base, node):
                                yield module.finding(
                                    self.id, node,
                                    f"argument '{base}' of '{fn.name}' is "
                                    f"mutated in place — the caller's "
                                    f"object changes underneath it")
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        base = root_name(t)
                        if still_param(base, node):
                            yield module.finding(
                                self.id, node,
                                f"argument '{base}' of '{fn.name}' is "
                                f"mutated in place (del)")
            elif isinstance(node, ast.Call):
                yield from self._check_call(module, fn, node, still_param)
            elif (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr in _MUTATOR_METHODS):
                # only a *discarded* result is a mutation smell: pure
                # methods that happen to share a mutator name (an
                # optimizer's update, a NamedTuple's replace) have their
                # result bound
                call = node.value
                base = root_name(call.func.value)
                if still_param(base, node):
                    yield module.finding(
                        self.id, call,
                        f"argument '{base}' of '{fn.name}' is mutated in "
                        f"place via .{call.func.attr}() — the caller's "
                        f"object changes underneath it")

    def _check_call(self, module, fn, call, still_param):
        if (isinstance(call.func, ast.Attribute)
                and _is_inplace_method(call.func.attr)):
            base = root_name(call.func.value)
            if still_param(base, call):
                yield module.finding(
                    self.id, call,
                    f"argument '{base}' of '{fn.name}' is mutated in place "
                    f"via .{call.func.attr}() — the caller's tensor "
                    f"changes underneath it")
        for kw in call.keywords:
            if kw.arg == "out":
                base = root_name(kw.value)
                if still_param(base, call):
                    yield module.finding(
                        self.id, call,
                        f"argument '{base}' of '{fn.name}' is written "
                        f"through out= — the caller's tensor changes "
                        f"underneath it")


# --------------------------------------------------------------- PT105


_NONDET_CALLS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.token_hex", "secrets.randbits",
}
#: torch's global generator: seeding it
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all"}
_PY_RANDOM_FNS = {"random", "randint", "randrange", "uniform", "choice",
                  "choices", "shuffle", "sample", "seed", "gauss",
                  "normalvariate", "betavariate", "getrandbits"}


class Nondeterminism(Rule):
    id = "PT105"
    name = "nondeterminism"
    summary = ("wall-clock / global-RNG (torch.rand* without generator=, "
               "torch.manual_seed, np.random, random) / set-iteration "
               "inside engine or fault-stream code — breaks the (seed, "
               "round, client) keying contract and bitwise engine parity "
               "(JX105's counterpart)")
    scope = ENGINE_SCOPE

    def check(self, module, project):
        imports_random = any(
            isinstance(n, ast.Import)
            and any(a.name == "random" for a in n.names)
            for n in ast.walk(module.tree))
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func) or ""
                if callee in _NONDET_CALLS:
                    yield module.finding(
                        self.id, node,
                        f"'{callee}' in engine code — results must be a "
                        f"pure function of (seed, round, client)")
                elif (callee.startswith("torch.rand")
                        and not any(kw.arg == "generator"
                                    for kw in node.keywords)):
                    yield module.finding(
                        self.id, node,
                        f"'{callee}' draws from torch's global generator "
                        f"in engine code — use repro_torch.prng keyed on "
                        f"(seed, round, client)")
                elif callee in _TORCH_SEEDS:
                    yield module.finding(
                        self.id, node,
                        f"'{callee}' reseeds torch's global generator in "
                        f"engine code — use repro_torch.prng keys")
                elif (callee.startswith("np.random.")
                        or callee.startswith("numpy.random.")):
                    yield module.finding(
                        self.id, node,
                        f"global numpy RNG '{callee}' in engine code — "
                        f"use repro_torch.prng keyed on (seed, round, "
                        f"client)")
                elif (imports_random and callee.startswith("random.")
                        and callee.split(".")[1] in _PY_RANDOM_FNS):
                    yield module.finding(
                        self.id, node,
                        f"python global RNG '{callee}' in engine code — "
                        f"use repro_torch.prng keyed on (seed, round, "
                        f"client)")
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if (isinstance(it, ast.Call)
                        and dotted_name(it.func) == "set"):
                    yield module.finding(
                        self.id, it,
                        "iterating a set() in engine code — iteration "
                        "order depends on PYTHONHASHSEED across "
                        "processes; sort it first")


# --------------------------------------------------------------- PT106


def _live_source(value: ast.AST) -> Optional[str]:
    """The step registry a value is taken live from: ``X`` for
    ``X.carry()``, ``X.traj`` and any subscript or attribute of them
    (``X.carry()["pop"].battery_pct``, ``X.traj["selected"]``)."""
    while isinstance(value, (ast.Subscript, ast.Attribute)):
        if isinstance(value, ast.Attribute) and value.attr == "traj":
            return dotted_name(value.value)
        value = value.value
    if (isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)
            and value.func.attr == "carry" and not value.args):
        return dotted_name(value.func.value)
    return None


class LiveCarryReadAfterRun(Rule):
    id = "PT106"
    name = "live-carry-read-after-run"
    summary = ("a tensor taken from a StepGraphs' carry() or traj is read "
               "after a later .run(...) of the same graphs, which "
               "overwrote it in place (JX106's counterpart: a read after "
               "a buffer was donated); copy it, or take it after the run")

    def check(self, module, project):
        for fn in iter_functions(module.tree):
            yield from self._check_body(module, fn)

    def _check_body(self, module, fn):
        takes: List[Tuple[Tuple[int, int], str, str]] = []
        runs: List[Tuple[Tuple[int, int], Tuple[int, int], str, int]] = []
        loads: List[Tuple[Tuple[int, int], str, ast.AST]] = []
        stores: List[Tuple[Tuple[int, int], str]] = []
        for node in own_nodes(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                owner = _live_source(node.value)
                if owner is not None:
                    takes.append((node_end(node), node.targets[0].id,
                                  owner))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "run"):
                owner = dotted_name(node.func.value)
                if owner is not None:
                    runs.append((node_pos(node), node_end(node), owner,
                                 node.lineno))
            elif isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.append((node_pos(node), node.id, node))
                else:
                    stores.append((node_pos(node), node.id))
        loads.sort(key=lambda x: x[0])
        for taken_at, name, owner in takes:
            run = min((r for r in runs if r[2] == owner and r[0] > taken_at),
                      default=None)
            if run is None:
                continue
            rebound = min((p for p, n in stores
                           if n == name and p > taken_at), default=None)
            for pos, n, load in loads:
                if n != name or pos <= run[1]:
                    continue
                if rebound is not None and rebound < pos:
                    break
                yield module.finding(
                    self.id, load,
                    f"'{name}' was taken live from '{owner}' and "
                    f"'{owner}.run' at line {run[3]} overwrote it in place "
                    f"— it now holds the later step's values")
                break


ALL_RULES: Sequence[Rule] = (
    PrngKeyReuse(),
    OptionalKnobTruthiness(),
    HostSyncInCaptured(),
    ArgMutation(),
    Nondeterminism(),
    LiveCarryReadAfterRun(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
