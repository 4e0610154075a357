"""The port's lint pass (``repro_torch.analysis``): should-fire /
should-not-fire cases for every rule, the JAX package's cases
(``tests/test_analysis.py``) rewritten in the port's idiom, each firing
or silent as its reference case; twin snippets that both packages' lints
flag at the same lines (rules 101-105); the baseline and the CLI, whose
JSON report has the reference's keys."""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import engine as jengine
from repro.analysis import rules as jrules
from repro_torch.analysis import engine as tengine
from repro_torch.analysis.engine import (
    Baseline,
    Module,
    ProjectIndex,
    analyze,
    run_rules,
    write_baseline,
)
from repro_torch.analysis.rules import (
    ALL_RULES,
    PT102_REQUIRED_KNOBS,
    ArgMutation,
    HostSyncInCaptured,
    LiveCarryReadAfterRun,
    Nondeterminism,
    OptionalKnobTruthiness,
    PrngKeyReuse,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_PATH = "src/repro_torch/federated/snippet.py"


def lint(src, rule=None, path=ENGINE_PATH):
    src = textwrap.dedent(src)
    mod = Module(path=path, source=src, tree=ast.parse(src))
    rules = ALL_RULES if rule is None else [rule]
    return run_rules([mod], rules)


def rule_ids(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------- PT101 key reuse


class TestPrngKeyReuse:
    def test_fires_on_recharge_style_reuse(self):
        # one key drawn for selection AND recharge
        src = """
            from repro_torch import prng
            def round_step(key, pop):
                sel = prng.uniform(key, (8,))
                recharge = prng.bernoulli(key, 0.25, (8,))
                return sel, recharge
        """
        fs = lint(src, PrngKeyReuse())
        assert rule_ids(fs) == ["PT101"]
        assert "recharge" in fs[0].snippet

    def test_silent_after_split(self):
        src = """
            from repro_torch import prng
            def round_step(key, pop):
                ksel, krecharge = prng.split(key).unbind(0)
                sel = prng.uniform(ksel, (8,))
                recharge = prng.bernoulli(krecharge, 0.25, (8,))
                return sel, recharge
        """
        assert lint(src, PrngKeyReuse()) == []

    def test_silent_on_fold_in_rederive(self):
        src = """
            from repro_torch import prng
            def stream(key, rnd):
                a = prng.uniform(prng.fold_in(key, 1), (4,))
                b = prng.uniform(prng.fold_in(key, 2), (4,))
                return a, b
        """
        assert lint(src, PrngKeyReuse()) == []

    def test_silent_across_exclusive_branches(self):
        src = """
            from repro_torch import prng
            def init(key, kind):
                if kind == "a":
                    return prng.uniform(key, (4,))
                return prng.normal(key, (4,))
        """
        assert lint(src, PrngKeyReuse()) == []

    def test_silent_after_reassignment(self):
        src = """
            from repro_torch import prng
            def loop(key):
                a = prng.uniform(key, (4,))
                key = prng.fold_in(key, 1)
                b = prng.uniform(key, (4,))
                return a, b
        """
        assert lint(src, PrngKeyReuse()) == []

    def test_silent_after_split_row_reassignment(self):
        # the port's idiom: a row of a split, or an unbind of one
        src = """
            from repro_torch import prng
            def loop(key, kloop):
                a = prng.uniform(key, (4,))
                key = prng.split(key, 3)[0]
                kloop, ksel, ktrain, krech = prng.split(kloop, 4).unbind(-2)
                b = prng.uniform(key, (4,))
                return a, b, ksel
        """
        assert lint(src, PrngKeyReuse()) == []

    def test_excluded_in_launch_checkers(self):
        src = """
            from repro_torch import prng
            def parity(key):
                a = engine_a(key)
                b = engine_b(key)
                return a, b
            def engine_a(key):
                return prng.uniform(key, (4,))
            def engine_b(key):
                return prng.uniform(key, (4,))
        """
        assert lint(src, PrngKeyReuse(),
                    path="src/repro_torch/launch/parity_check.py") == []
        assert lint(src, PrngKeyReuse()) != []


# ---------------------------------------------------- PT102 truthiness


class TestOptionalKnobTruthiness:
    DEADLINE_SRC = """
        from dataclasses import dataclass
        from typing import Optional

        @dataclass
        class FLConfig:
            deadline_s: Optional[float] = None

        def round_deadline(cfg):
            if cfg.deadline_s:   # 0.0 means "no deadline" here: the bug
                return cfg.deadline_s
            return 1e9
    """

    def test_fires_on_deadline_truthiness(self):
        fs = lint(self.DEADLINE_SRC, OptionalKnobTruthiness())
        assert rule_ids(fs) == ["PT102"]
        assert "deadline_s" in fs[0].message

    def test_silent_on_is_not_none(self):
        src = self.DEADLINE_SRC.replace("if cfg.deadline_s:",
                                        "if cfg.deadline_s is not None:")
        assert lint(src, OptionalKnobTruthiness()) == []

    def test_silent_on_plain_float_field(self):
        src = """
            from dataclasses import dataclass

            @dataclass
            class FLConfig:
                fedprox_mu: float = 0.0

            def has_prox(cfg):
                if cfg.fedprox_mu:
                    return True
                return False
        """
        assert lint(src, OptionalKnobTruthiness()) == []

    def test_fires_on_optional_param_or_default(self):
        src = """
            from typing import Optional
            def pick(rounds: Optional[int], default: int):
                return rounds or default
        """
        fs = lint(src, OptionalKnobTruthiness())
        assert rule_ids(fs) == ["PT102"]

    BUDGET_SRC = """
        from dataclasses import dataclass
        from typing import Optional

        @dataclass
        class FLConfig:
            energy_budget_j: Optional[float] = None

        def metered(cfg):
            if cfg.energy_budget_j:   # 0.0 J = refuse everything, not unmetered
                return True
            return False
    """

    def test_fires_on_budget_truthiness(self):
        fs = lint(self.BUDGET_SRC, OptionalKnobTruthiness())
        assert rule_ids(fs) == ["PT102"]
        assert "energy_budget_j" in fs[0].message

    def test_silent_on_budget_is_not_none(self):
        src = self.BUDGET_SRC.replace(
            "if cfg.energy_budget_j:",
            "if cfg.energy_budget_j is not None:")
        assert lint(src, OptionalKnobTruthiness()) == []

    RING_SRC = """
        from dataclasses import dataclass
        from typing import Optional

        @dataclass
        class FLConfig:
            snapshot_ring_size: Optional[int] = None

        def ring_capacity(cfg, max_concurrency):
            if cfg.snapshot_ring_size:   # 0 must be rejected, not defaulted
                return cfg.snapshot_ring_size
            return max_concurrency
    """

    def test_fires_on_ring_size_truthiness(self):
        fs = lint(self.RING_SRC, OptionalKnobTruthiness())
        assert rule_ids(fs) == ["PT102"]
        assert "snapshot_ring_size" in fs[0].message

    def test_silent_on_ring_size_is_not_none(self):
        src = self.RING_SRC.replace(
            "if cfg.snapshot_ring_size:",
            "if cfg.snapshot_ring_size is not None:")
        assert lint(src, OptionalKnobTruthiness()) == []

    def test_project_scan_indexes_required_knobs(self):
        """Every knob in PT102_REQUIRED_KNOBS (the reference's JX102 set)
        must appear in the Optional registry built from the real
        src/repro_torch tree — a refactor that drops an Optional
        annotation would otherwise blind PT102 without failing
        anything."""
        assert PT102_REQUIRED_KNOBS == jrules.JX102_REQUIRED_KNOBS
        mods = []
        for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
            src = p.read_text()
            mods.append(Module(path=str(p), source=src,
                               tree=ast.parse(src)))
        idx = ProjectIndex(mods)
        missing = PT102_REQUIRED_KNOBS - set(idx.optional_numeric_fields)
        assert not missing, (
            f"Optional-knob registry lost {sorted(missing)} — PT102 no "
            f"longer guards their 0-vs-None semantics")


# ------------------------------------------------------ PT103 host sync


class TestHostSyncInCaptured:
    def test_fires_on_item_in_step(self):
        src = """
            def round_fn(carry, ctr):
                return carry, {"s": carry["x"].sum().item()}
        """
        fs = lint(src, HostSyncInCaptured())
        assert rule_ids(fs) == ["PT103"]

    def test_fires_on_numpy_in_step_callee(self):
        src = """
            import numpy as np
            def helper(x):
                return np.asarray(x).mean()
            def body(carry, x):
                return carry, helper(x)
            def run(graphs):
                graphs.add("round", body, advance=True)
        """
        fs = lint(src, HostSyncInCaptured())
        assert rule_ids(fs) == ["PT103"]
        assert "np.asarray" in fs[0].snippet

    def test_silent_on_host_only_function(self):
        src = """
            import numpy as np
            def summarize(traj):
                return float(np.asarray(traj).mean())
        """
        assert lint(src, HostSyncInCaptured()) == []

    def test_silent_on_torch_in_step(self):
        src = """
            import torch
            def round_fn(carry, ctr):
                return carry, {"m": torch.mean(carry["x"])}
        """
        assert lint(src, HostSyncInCaptured()) == []

    def test_fires_on_each_host_read(self):
        src = """
            import torch
            def round_fn(carry, ctr):
                x = carry["x"]
                a = float(x.sum())
                b = x[x > 0]
                c = torch.nonzero(x)
                d = torch.tensor([1.0, 2.0])
                e = x.cpu()
                f = bool(x.any())
                return carry, {}
        """
        fs = lint(src, HostSyncInCaptured())
        assert [f.line for f in fs] == [5, 6, 7, 8, 9, 10]

    def test_silent_on_metadata_casts(self):
        src = """
            import torch
            def round_fn(carry, ctr):
                x = carry["x"]
                n = int(x.shape[0]) + int(len(carry)) + int(x.numel())
                m = float(x.ndim * 2)
                return carry, {"y": x * n * m}
        """
        assert lint(src, HostSyncInCaptured()) == []

    def test_roots_transforms_autograd_and_graph_blocks(self):
        src = """
            import torch
            from torch.func import grad_and_value, vmap
            def loss_fn(p, x):
                return float(p.sum())
            step = vmap(grad_and_value(loss_fn))
            class Op(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x):
                    return x.item()
            def body(s):
                return s.tolist()
            def capture(graph, s):
                with torch.cuda.graph(graph):
                    body(s)
                    s.numpy()
                return s.numpy()
        """
        fs = lint(src, HostSyncInCaptured())
        assert [f.line for f in fs] == [5, 10, 12, 16]

    def test_silent_outside_the_graph_block(self):
        src = """
            import torch
            def capture(graph, s):
                n = s.item()
                with torch.cuda.graph(graph):
                    s.add_(1)
                return n
        """
        assert lint(src, HostSyncInCaptured()) == []


# ---------------------------------------------------- PT104 arg mutation


class TestArgMutation:
    def test_fires_on_overcommit_style_mutation(self):
        # capping stragglers by writing into the caller's outcome
        src = """
            def cap_stragglers(outcome, k):
                outcome.succeeded[k:] = False
                return outcome
        """
        fs = lint(src, ArgMutation())
        assert rule_ids(fs) == ["PT104"]

    def test_fires_on_discarded_mutator_call(self):
        src = """
            def record(hist, x):
                hist.append(x)
        """
        fs = lint(src, ArgMutation())
        assert rule_ids(fs) == ["PT104"]

    def test_silent_after_defensive_copy(self):
        src = """
            def annotate(traj, x):
                traj = dict(traj)
                traj["x"] = x
                return traj
        """
        assert lint(src, ArgMutation()) == []

    def test_silent_on_pure_update_with_bound_result(self):
        src = """
            def server_update(params, grad, opt, opt_state):
                updates, opt_state = opt.update(grad, opt_state, params)
                return updates, opt_state
        """
        assert lint(src, ArgMutation()) == []

    def test_silent_on_kernel_output_buffers(self):
        src = """
            def launch(lib, x, out, out_idx, lse_out):
                out.copy_(x)
                out_idx[...] = 0
                lse_out.zero_()
        """
        assert lint(src, ArgMutation()) == []

    def test_scoped_to_engine_code(self):
        src = """
            def record(hist, x):
                hist.append(x)
        """
        assert lint(src, ArgMutation(),
                    path="src/repro_torch/launch/report.py") == []

    def test_fires_on_inplace_methods_and_out(self):
        src = """
            import torch
            def step(pop, x, y):
                b = pop.battery.clamp_(0.0, 100.0)
                x.index_copy_(0, y, y)
                torch.add(y, 1, out=y)
                return b
        """
        fs = lint(src, ArgMutation())
        assert [f.line for f in fs] == [4, 5, 6]

    def test_silent_on_clone_first(self):
        src = """
            def step(x, y):
                x = x.clone()
                x.add_(1)
                z = y.clone().mul_(2)
                return x, z
        """
        assert lint(src, ArgMutation()) == []


# -------------------------------------------------- PT105 nondeterminism


class TestNondeterminism:
    def test_fires_on_wall_clock(self):
        src = """
            import time
            def round_timer():
                return time.time()
        """
        fs = lint(src, Nondeterminism())
        assert rule_ids(fs) == ["PT105"]

    def test_fires_on_global_numpy_rng(self):
        src = """
            import numpy as np
            def jitter(n):
                return np.random.uniform(size=n)
        """
        fs = lint(src, Nondeterminism())
        assert rule_ids(fs) == ["PT105"]

    def test_fires_on_set_iteration(self):
        src = """
            def flatten(streams):
                out = []
                for s in set(streams):
                    out.append(s)
                return out
        """
        fs = lint(src, Nondeterminism())
        assert rule_ids(fs) == ["PT105"]

    def test_silent_on_sorted_set_and_keyed_rng(self):
        src = """
            from repro_torch import prng
            def stream(seed, rnd, names):
                key = prng.fold_in(prng.PRNGKey(seed), rnd)
                return [(n, prng.uniform(prng.fold_in(key, i)))
                        for i, n in enumerate(sorted(set(names)))]
        """
        assert lint(src, Nondeterminism()) == []

    def test_scoped_to_engine_code(self):
        src = """
            import time
            def stamp():
                return time.time()
        """
        assert lint(src, Nondeterminism(),
                    path="src/repro_torch/launch/bench.py") == []

    def test_fires_on_torch_global_generator(self):
        src = """
            import torch
            def draws(n, g):
                a = torch.rand(n)
                b = torch.randint(0, 9, (n,))
                c = torch.randperm(n)
                torch.manual_seed(0)
                d = torch.randn(n, generator=g)
                return a, b, c, d
        """
        fs = lint(src, Nondeterminism())
        assert [f.line for f in fs] == [4, 5, 6, 7]


# ------------------------------------------ PT106 live carry after run


class TestLiveCarryReadAfterRun:
    def test_fires_on_carry_read_after_run(self):
        src = """
            def loop(graphs):
                pop = graphs.carry()["pop"]
                graphs.run("round")
                return pop.battery_pct
        """
        fs = lint(src, LiveCarryReadAfterRun())
        assert rule_ids(fs) == ["PT106"]
        assert "pop" in fs[0].message

    def test_fires_on_traj_read_after_run(self):
        src = """
            def loop(graphs):
                sel = graphs.traj["selected"]
                graphs.run("round")
                return sel[0]
        """
        assert rule_ids(lint(src, LiveCarryReadAfterRun())) == ["PT106"]

    def test_silent_when_taken_after_the_run(self):
        src = """
            def loop(graphs):
                graphs.run("round")
                carry = graphs.carry()
                return carry["pop"]
        """
        assert lint(src, LiveCarryReadAfterRun()) == []

    def test_silent_when_copied_or_rebound(self):
        src = """
            def loop(graphs, other):
                pop = graphs.carry()["pop"].clone()
                st = graphs.carry()["st"]
                other.run("round")
                graphs.run("round")
                st = graphs.carry()["st"]
                return pop, st
        """
        assert lint(src, LiveCarryReadAfterRun()) == []


# ------------------------------------------- parity with the JAX lint

#: twin snippets (JAX idiom, port idiom), line for line
TWINS = {
    "101": ("""
        import jax
        def round_step(key, pop):
            sel = jax.random.uniform(key, (8,))
            recharge = jax.random.bernoulli(key, 0.25, (8,))
            ksel, krech = jax.random.split(key)
            a = jax.random.uniform(ksel, (8,))
            b = jax.random.normal(krech, (8,))
            c = jax.random.normal(krech, (8,))
            return sel, recharge, a, b, c
    """, """
        from repro_torch import prng
        def round_step(key, pop):
            sel = prng.uniform(key, (8,))
            recharge = prng.bernoulli(key, 0.25, (8,))
            ksel, krech = prng.split(key).unbind(0)
            a = prng.uniform(ksel, (8,))
            b = prng.normal(krech, (8,))
            c = prng.normal(krech, (8,))
            return sel, recharge, a, b, c
    """),
    "102": ("""
        from dataclasses import dataclass
        from typing import Optional
        @dataclass
        class FLConfig:
            deadline_s: Optional[float] = None
            buffer_size: Optional[int] = None
        def deadline(cfg, rounds: Optional[int]):
            a = cfg.deadline_s if cfg.deadline_s else 1e9
            b = cfg.buffer_size if cfg.buffer_size is not None else 1
            return a, b, rounds or 3
    """, """
        from dataclasses import dataclass
        from typing import Optional
        @dataclass
        class FLConfig:
            deadline_s: Optional[float] = None
            buffer_size: Optional[int] = None
        def deadline(cfg, rounds: Optional[int]):
            a = cfg.deadline_s if cfg.deadline_s else 1e9
            b = cfg.buffer_size if cfg.buffer_size is not None else 1
            return a, b, rounds or 3
    """),
    "103": ("""
        import jax
        import numpy as np
        def helper(x):
            return np.asarray(x).mean()
        def body(carry, x):
            s = x.sum().item()
            t = float(carry)
            return carry, helper(x) + s + t
        def host(xs):
            return float(np.asarray(xs).sum())
        def run(xs):
            return jax.lax.scan(body, 0.0, xs)
    """, """
        import torch
        import numpy as np
        def helper(x):
            return np.asarray(x).mean()
        def body(carry, x):
            s = x.sum().item()
            t = float(carry)
            return carry, helper(x) + s + t
        def host(xs):
            return float(np.asarray(xs).sum())
        def run(graphs):
            graphs.add("round", body, advance=True)
    """),
    "104": ("""
        def cap_stragglers(outcome, k, hist, buf, x):
            outcome.succeeded[k:] = False
            hist.append(k)
            buf[...] = x
            x = dict(x)
            x["k"] = k
            return outcome
    """, """
        def cap_stragglers(outcome, k, hist, buf, x):
            outcome.succeeded[k:] = False
            hist.append(k)
            buf.copy_(x)
            x = dict(x)
            x["k"] = k
            return outcome
    """),
    "105": ("""
        import time
        import numpy as np
        import jax
        def stream(n, streams, key):
            t = time.time()
            a = np.random.uniform(size=n)
            b = np.random.normal(size=n)
            c = jax.random.normal(key, (n,))
            return [s for s in set(streams)], t, a, b, c
    """, """
        import time
        import numpy as np
        import torch
        def stream(n, streams, key):
            t = time.time()
            a = np.random.uniform(size=n)
            b = torch.randn(n)
            c = torch.randn(n, generator=key)
            return [s for s in set(streams)], t, a, b, c
    """),
}


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_twin_snippets_flag_the_same_lines(rule, tmp_path):
    jsrc, tsrc = (textwrap.dedent(s) for s in TWINS[rule])
    assert len(jsrc.splitlines()) == len(tsrc.splitlines())
    lines = {}
    for pkg, src, mod in (("jax", jsrc, jengine), ("torch", tsrc, tengine)):
        d = tmp_path / pkg / "federated"
        d.mkdir(parents=True)
        (d / "snippet.py").write_text(src)
        report = mod.analyze([str(d)])
        lines[pkg] = sorted(f.line for f in report.findings
                            if f.rule.endswith(rule))
        assert {f.rule[:2] for f in report.findings} <= {"JX", "PT"}
    assert lines["jax"], "the twin must fire"
    assert lines["jax"] == lines["torch"]


def test_report_keys_equal_the_reference(tmp_path):
    src = textwrap.dedent(TestBaseline.FINDING_SRC)
    d = tmp_path / "federated"
    d.mkdir()
    (d / "snippet.py").write_text(src)
    jdoc = jengine.analyze([str(d)]).to_json()
    tdoc = analyze([str(d)]).to_json()
    assert list(tdoc) == list(jdoc)
    assert list(tdoc["counts"]) == list(jdoc["counts"])
    assert [list(f) for f in tdoc["findings"]] == \
        [list(f) for f in jdoc["findings"]]
    assert tdoc["tool"] == "repro_torch.analysis"
    assert jdoc["tool"] == "repro.analysis"
    assert [f["line"] for f in tdoc["findings"]] == \
        [f["line"] for f in jdoc["findings"]]


# --------------------------------------------- engine plumbing + baseline


class TestBaseline:
    FINDING_SRC = textwrap.dedent("""
        import time
        def stamp():
            return time.time()
    """)

    def _sub(self, tmp_path, src=None):
        sub = tmp_path / "federated"
        sub.mkdir(exist_ok=True)
        (sub / "snippet.py").write_text(src or self.FINDING_SRC)
        return sub

    def test_unbaselined_finding_fails(self, tmp_path):
        report = analyze([str(self._sub(tmp_path))], baseline_path=None)
        assert report.exit_code == 1
        assert [f.rule for f in report.new] == ["PT105"]

    def test_baselined_finding_passes(self, tmp_path):
        sub = self._sub(tmp_path)
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps({"version": 1, "suppressions": [{
            "rule": "PT105", "file": "federated/snippet.py",
            "snippet": "return time.time()",
            "justification": "bench-only wall clock, not in a trajectory",
        }]}))
        report = analyze([str(sub)], baseline_path=str(bl))
        assert report.exit_code == 0
        assert len(report.baselined) == 1 and not report.new

    def test_todo_justification_fails(self, tmp_path):
        sub = self._sub(tmp_path)
        bl = tmp_path / "baseline.json"
        findings = analyze([str(sub)], baseline_path=None).findings
        write_baseline(str(bl), findings, Baseline.load(None))
        report = analyze([str(sub)], baseline_path=str(bl))
        assert report.todo_suppressions and report.exit_code == 1

    def test_write_baseline_preserves_justifications(self, tmp_path):
        sub = self._sub(tmp_path)
        findings = analyze([str(sub)], baseline_path=None).findings
        bl = tmp_path / "baseline.json"
        write_baseline(str(bl), findings, Baseline.load(None))
        entries = json.loads(bl.read_text())["suppressions"]
        entries[0]["justification"] = "real reason"
        bl.write_text(json.dumps({"version": 1, "suppressions": entries}))
        write_baseline(str(bl), findings, Baseline.load(str(bl)))
        kept = json.loads(bl.read_text())["suppressions"]
        assert kept[0]["justification"] == "real reason"

    def test_baseline_survives_line_drift(self, tmp_path):
        sub = self._sub(tmp_path)
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps({"version": 1, "suppressions": [{
            "rule": "PT105", "file": "federated/snippet.py",
            "snippet": "return time.time()",
            "justification": "bench-only",
        }]}))
        # shift the finding down two lines: snippet-keyed matching holds
        self._sub(tmp_path, "# pad\n# pad\n" + self.FINDING_SRC)
        report = analyze([str(sub)], baseline_path=str(bl))
        assert report.exit_code == 0 and len(report.baselined) == 1

    def test_shipped_baseline_is_justified(self):
        doc = json.loads((ROOT / "analysis-baseline-torch.json").read_text())
        assert set(doc) == {"version", "suppressions"}
        for s in doc["suppressions"]:
            assert set(s) == {"rule", "file", "snippet", "justification"}
            assert s["rule"].startswith("PT") and s["file"].startswith(
                "src/repro_torch/")
            assert "TODO" not in s["justification"]


class TestCli:
    def _run(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            capture_output=True, text=True, cwd=ROOT,
            env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})

    def test_json_schema_stable(self, tmp_path):
        sub = tmp_path / "federated"
        sub.mkdir()
        (sub / "snippet.py").write_text(TestBaseline.FINDING_SRC)
        r = self._run(str(sub), "--format", "json", "--no-baseline")
        assert r.returncode == 1, r.stderr
        doc = json.loads(r.stdout)
        assert set(doc) == {"version", "tool", "files_scanned", "rules",
                            "findings", "counts", "unused_suppressions",
                            "todo_suppressions", "exit_code"}
        assert doc["version"] == 1 and doc["tool"] == "repro_torch.analysis"
        assert set(doc["rules"]) == {"PT101", "PT102", "PT103", "PT104",
                                     "PT105", "PT106"}
        (finding,) = doc["findings"]
        assert set(finding) == {"rule", "file", "line", "col", "message",
                                "snippet", "baselined"}
        assert finding["rule"] == "PT105" and finding["line"] == 4
        assert finding["baselined"] is False

    def test_shipped_tree_is_clean(self):
        r = self._run("src/repro_torch", "--format", "json")
        assert r.returncode == 0, r.stdout + r.stderr
        doc = json.loads(r.stdout)
        assert doc["counts"]["new"] == 0
        assert doc["todo_suppressions"] == []
        assert doc["unused_suppressions"] == []
        r = self._run("--no-baseline", "--format", "json")
        assert r.returncode == 1
        assert json.loads(r.stdout)["counts"]["total"] == \
            doc["counts"]["baselined"]

    def test_list_rules(self):
        r = self._run("--list-rules")
        assert r.returncode == 0
        for n in range(101, 107):
            assert f"PT{n}" in r.stdout and f"JX{n}" in r.stdout

    def test_usage_error(self):
        assert self._run("no/such/path").returncode == 2


def test_every_rule_has_id_name_summary():
    ids = [r.id for r in ALL_RULES]
    assert len(ids) == len(set(ids)) == 6
    jx = {r.id[2:]: r.name for r in jrules.ALL_RULES}
    for r in ALL_RULES:
        assert r.id.startswith("PT") and r.name and r.summary
        assert f"JX{r.id[2:]}" in r.summary
        assert r.id[2:] in jx
