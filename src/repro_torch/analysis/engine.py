"""Rule engine for the port's PyTorch-hazard lint pass.

Pure stdlib (``ast`` + ``json``): the static half of
``repro_torch.analysis`` runs with no torch installed. The engine walks a
set of python files, parses each once, builds a project-wide index (the
Optional-numeric knob registry and per-module captured-reachability call
graphs), runs every registered rule, and reconciles the findings against
a checked-in baseline file.

Baseline entries match on ``(rule, file, snippet)`` — the *stripped
source line*, not the line number — so unrelated edits that shift lines
do not invalidate a suppression, while any change to the flagged line
itself surfaces the finding again for re-triage. Every entry carries a
mandatory human justification; ``--write-baseline`` refuses to invent
one (it stamps a TODO that the run rejects).

The report's JSON and the baseline's format are the JAX package's
(``repro.analysis``), key for key.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

JSON_SCHEMA_VERSION = 1
TODO_JUSTIFICATION = "TODO: justify this suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str       # rule id, e.g. "PT102"
    file: str       # path as given to the analyzer (posix separators)
    line: int       # 1-based
    col: int        # 0-based
    message: str
    snippet: str    # stripped source line — the baseline matching key

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.snippet)


@dataclass
class Module:
    """One parsed source file, shared by all rules."""

    path: str
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, file=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message,
                       snippet=self.snippet(getattr(node, "lineno", 1)))


class ProjectIndex:
    """Cross-file facts computed once before rules run.

    ``optional_numeric_fields`` maps attribute names of dataclass /
    NamedTuple fields annotated ``Optional[int|float|bool]`` (or the
    PEP-604 spelling) to the annotation text — the registry the
    truthiness rule checks attribute accesses against.
    """

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.optional_numeric_fields: Dict[str, str] = {}
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self._index_class(node)

    def _index_class(self, cls: ast.ClassDef) -> None:
        for stmt in cls.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                anno = annotation_text(stmt.annotation)
                if is_optional_numeric(anno):
                    self.optional_numeric_fields[stmt.target.id] = anno


def annotation_text(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node).replace(" ", "")
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return ""


_OPTIONAL_NUMERIC = ("int", "float", "bool")


def is_optional_numeric(anno: str) -> bool:
    """True for Optional[int|float|bool] in any common spelling."""
    anno = anno.replace("typing.", "").replace("builtins.", "")
    for t in _OPTIONAL_NUMERIC:
        if anno in (f"Optional[{t}]", f"{t}|None", f"None|{t}"):
            return True
    return False


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """The base Name of an arbitrarily nested Attribute/Subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def node_pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def node_end(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "end_lineno", getattr(node, "lineno", 0)),
            getattr(node, "end_col_offset", getattr(node, "col_offset", 0)))


def iter_functions(tree: ast.AST):
    """All (async) function defs, outermost-first."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def own_nodes(fn: ast.AST):
    """Walk a function body WITHOUT descending into nested function
    definitions (each nested def is analyzed in its own scope)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------- discovery


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.join(dirpath, f))
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    return [os.path.normpath(p).replace(os.sep, "/") for p in out]


def parse_modules(files: Sequence[str]) -> List[Module]:
    mods = []
    for path in files:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        mods.append(Module(path=path, source=source,
                           tree=ast.parse(source, filename=path)))
    return mods


# ----------------------------------------------------------------- baseline


@dataclass
class Baseline:
    path: Optional[str]
    suppressions: List[Dict[str, str]] = field(default_factory=list)

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if path is None or not os.path.exists(path):
            return cls(path=path)
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        sups = raw.get("suppressions", [])
        for s in sups:
            missing = {"rule", "file", "snippet", "justification"} - set(s)
            if missing:
                raise ValueError(
                    f"baseline entry {s!r} is missing {sorted(missing)}")
        return cls(path=path, suppressions=list(sups))

    def match(self, finding: Finding) -> Optional[Dict[str, str]]:
        for s in self.suppressions:
            if (s["rule"] == finding.rule
                    and finding.file.endswith(s["file"])
                    and s["snippet"] == finding.snippet):
                return s
        return None

    def unused(self, findings: Sequence[Finding]) -> List[Dict[str, str]]:
        used = {(s["rule"], s["file"], s["snippet"])
                for f in findings
                for s in [self.match(f)] if s is not None}
        return [s for s in self.suppressions
                if (s["rule"], s["file"], s["snippet"]) not in used]

    def todo_entries(self) -> List[Dict[str, str]]:
        return [s for s in self.suppressions
                if s["justification"].startswith("TODO")]


def write_baseline(path: str, findings: Sequence[Finding],
                   previous: Baseline) -> None:
    """Write a baseline suppressing ``findings``, keeping any existing
    justifications; new entries get a TODO the run refuses."""
    old = {(s["rule"], s["file"], s["snippet"]): s["justification"]
           for s in previous.suppressions}
    entries, seen = [], set()
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        k = f.key()
        if k in seen:
            continue
        seen.add(k)
        entries.append({
            "rule": f.rule, "file": f.file, "snippet": f.snippet,
            "justification": old.get(k, TODO_JUSTIFICATION),
        })
    payload = {"version": JSON_SCHEMA_VERSION, "suppressions": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, ensure_ascii=False)
        fh.write("\n")


# ------------------------------------------------------------------ running


def run_rules(modules: Sequence[Module], rules=None) -> List[Finding]:
    from repro_torch.analysis.rules import ALL_RULES
    rules = ALL_RULES if rules is None else rules
    project = ProjectIndex(modules)
    findings: List[Finding] = []
    for mod in modules:
        for rule in rules:
            if rule.applies_to(mod.path):
                findings.extend(rule.check(mod, project))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


@dataclass
class Report:
    findings: List[Finding]
    baselined: List[Finding]
    new: List[Finding]
    unused_suppressions: List[Dict[str, str]]
    todo_suppressions: List[Dict[str, str]]
    files_scanned: int

    @property
    def exit_code(self) -> int:
        return 1 if (self.new or self.todo_suppressions) else 0

    def to_json(self) -> Dict[str, Any]:
        from repro_torch.analysis.rules import ALL_RULES
        baselined_keys = {f.key() for f in self.baselined}
        return {
            "version": JSON_SCHEMA_VERSION,
            "tool": "repro_torch.analysis",
            "files_scanned": self.files_scanned,
            "rules": {r.id: {"name": r.name, "summary": r.summary}
                      for r in ALL_RULES},
            "findings": [dict(dataclasses.asdict(f),
                              baselined=f.key() in baselined_keys)
                         for f in self.findings],
            "counts": {"total": len(self.findings),
                       "baselined": len(self.baselined),
                       "new": len(self.new)},
            "unused_suppressions": self.unused_suppressions,
            "todo_suppressions": self.todo_suppressions,
            "exit_code": self.exit_code,
        }

    def to_text(self) -> str:
        lines = []
        baselined_keys = {f.key() for f in self.baselined}
        for f in self.findings:
            tag = " [baselined]" if f.key() in baselined_keys else ""
            lines.append(f"{f.file}:{f.line}:{f.col}: {f.rule}{tag}: "
                         f"{f.message}")
            lines.append(f"    {f.snippet}")
        for s in self.unused_suppressions:
            lines.append(f"warning: unused baseline suppression "
                         f"{s['rule']} @ {s['file']}: {s['snippet']!r}")
        for s in self.todo_suppressions:
            lines.append(f"error: baseline entry {s['rule']} @ {s['file']} "
                         f"has a TODO justification — write a real one")
        lines.append(f"{self.files_scanned} files scanned: "
                     f"{len(self.findings)} finding(s), "
                     f"{len(self.baselined)} baselined, "
                     f"{len(self.new)} new")
        return "\n".join(lines)


def analyze(paths: Sequence[str], baseline_path: Optional[str] = None,
            rules=None) -> Report:
    """Run the full pass: discover, parse, lint, reconcile baseline."""
    files = collect_files(paths)
    modules = parse_modules(files)
    findings = run_rules(modules, rules)
    baseline = Baseline.load(baseline_path)
    baselined = [f for f in findings if baseline.match(f) is not None]
    new = [f for f in findings if baseline.match(f) is None]
    return Report(findings=findings, baselined=baselined, new=new,
                  unused_suppressions=baseline.unused(findings),
                  todo_suppressions=baseline.todo_entries(),
                  files_scanned=len(files))
