"""``repro_torch.analysis`` and ``repro_torch.guard``: the counterparts of
the reference's ``tests/test_analysis.py`` lint and guard cases, with
torch snippets. Every SYNC, DTYPE and DET code is flagged and cleared on a
known-bad / known-good corpus; the pragma grammar and the CLI's exit
status; the port's own tree is clean; importing the package loads neither
torch nor jax; and the runtime equalities ``guard.measured_transfers() ==
the hand-incremented read counters`` hold for stages, one-shot,
checkpointed, pipeline, cascade and dynamic runs on the CPU (where the
region only counts: torch's sync debug mode needs CUDA)."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import guard  # noqa: E402
from repro_torch.analysis import (determinism_lint, dtype_lint,  # noqa: E402
                                  run_analysis, sync_lint)
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.analysis.common import SourceFile  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_SRC = str(REPO / "src" / "repro_torch")
CPU = torch.device("cpu")


def lint(checker, text, path="snippet.py"):
    sf = SourceFile.parse(path=path, text=textwrap.dedent(text))
    return checker.check(sf)


def codes(findings):
    return sorted({f.code for f in findings})


# ---------------------------------------------------------------------------
# sync-lint: every code flagged, then cleared
# ---------------------------------------------------------------------------


SYNC_BAD = {
    "SYNC001": """
        import torch

        def f(x):
            d = torch.minimum(x, torch.zeros_like(x))
            return int(d.max()), float(d.sum()), bool(d.any())
    """,
    "SYNC002": """
        import torch

        def f(n):
            d = torch.cumsum(torch.ones(n), 0)
            return d.item(), d.tolist()
    """,
    "SYNC003": """
        import numpy as np
        import torch

        def f(n):
            d = torch.sort(torch.rand(n)).values
            return d.cpu(), d.numpy(), np.asarray(d)
    """,
    "SYNC004": """
        import torch

        def f(x: torch.Tensor):
            if x.any():
                return 1
            return 0 if x.sum() > 0 else 2
    """,
    "SYNC005": """
        import torch

        def f(n):
            d = torch.arange(n).abs()
            return [v for v in d]
    """,
    "SYNC006": """
        import torch

        def f(start, end):
            torch.cuda.synchronize()
            end.synchronize()
            return start.elapsed_time(end)
    """,
}


@pytest.mark.parametrize("code", sorted(SYNC_BAD))
def test_sync_code_flagged(code):
    fs = lint(sync_lint, SYNC_BAD[code])
    assert codes(fs) == [code]


def test_sync_counts_every_sink():
    assert len(lint(sync_lint, SYNC_BAD["SYNC001"])) == 3
    assert len(lint(sync_lint, SYNC_BAD["SYNC002"])) == 2
    assert len(lint(sync_lint, SYNC_BAD["SYNC003"])) == 3
    assert len(lint(sync_lint, SYNC_BAD["SYNC004"])) == 2


@pytest.mark.parametrize("snippet", [
    # the sanctioned fetch: its result is host numpy
    """
    import torch
    from repro_torch import guard

    def f(x: torch.Tensor):
        stats = torch.stack([x.sum(), x.max()])
        host = guard.fetch(stats, reason="test: packed stats")
        if host[0]:
            return int(host[0]), float(host[1])
        return [int(v) for v in host]
    """,
    # metadata and identity checks are host-side
    """
    import torch

    def f(x: torch.Tensor, y):
        d = torch.square(x)
        n = d.shape[0] + d.numel() + d.dim() + d.size(0)
        if y is None and d.dtype == torch.int32 and d.device.type == "cpu":
            return n
        return d.ndim
    """,
    # calls that return host values are no seeds
    """
    import torch

    def f(dtype):
        big = torch.finfo(dtype).max
        dev = torch.device("cpu")
        if torch.cuda.is_available() and big > 0:
            return int(torch.iinfo(torch.int32).max)
        return float(big) if dev.type == "cpu" else 0.0
    """,
    # an unannotated parameter, and a Sequence of tensors, are host values
    """
    from typing import Sequence
    import torch

    def f(x, planes: Sequence[torch.Tensor]):
        for p in planes:
            x = x + 1
        return int(x)
    """,
])
def test_sync_host_values_are_clear(snippet):
    assert lint(sync_lint, snippet) == []


def test_sync_tuple_display_is_not_a_tensor():
    """The seed narrowed on the port's tree: iterating a tuple display of
    tensors (``for t in (q, k, v)``) walks a host container, not a tensor;
    the loop variable still carries the elements' taint, position by
    position."""
    fs = lint(sync_lint, """
        import torch

        def f(q: torch.Tensor, k: torch.Tensor):
            for name, t, want in (("q", q, torch.float32),
                                  ("k", k, torch.int32)):
                if t.dtype != want:
                    raise ValueError(name)
            ptrs = [t.data_ptr() for t in (q, k)]
            for t in (q, k):
                if t.sum():
                    return ptrs
            return None
    """)
    # only the real read: the truth value of t.sum()
    assert [f.code for f in fs] == ["SYNC004"]


def test_sync_torch_module_aliases_are_roots():
    fs = lint(sync_lint, """
        import torch.nn.functional as F

        def f(x):
            return float(F.softmax(x, -1).max())
    """)
    assert codes(fs) == ["SYNC001"]


def test_sync_taint_is_flow_sensitive():
    """A host int later rebound to a tensor does not poison its earlier
    uses; a name carried around a loop does reach the top of the body."""
    assert lint(sync_lint, """
        import torch

        def f(n):
            k = 3
            a = int(k)
            k = torch.zeros(n)
            return a, k
    """) == []
    fs = lint(sync_lint, """
        import torch

        def f(n):
            c = 0
            for _ in range(n):
                if c:
                    break
                c = torch.ones(()).sum()
            return c
    """)
    assert codes(fs) == ["SYNC004"]


# ---------------------------------------------------------------------------
# dtype-bound-lint
# ---------------------------------------------------------------------------


class TestDtypeLint:
    BAD = """
        import torch

        def relax(src, w, n):
            d = torch.full((n,), 2**30, dtype=torch.int32)
            return torch.minimum(d, d[src] + w)
    """

    def test_int32_overflow_pattern_flagged(self):
        assert codes(lint(dtype_lint, self.BAD)) == ["DTYPE001"]

    def test_int32_cast_flagged(self):
        fs = lint(dtype_lint, """
            def relax(dist, weights, src):
                return (dist[src] + weights).to(torch.int32)
        """)
        assert codes(fs) == ["DTYPE001"]

    def test_dtype_helper_clears_the_finding(self):
        fs = lint(dtype_lint, """
            import torch
            from repro_torch.core.sssp import sssp_dtype_for

            def relax(src, w, n, wmax):
                dt, inf = sssp_dtype_for(n, wmax, 0)
                d = torch.full((n,), inf, dtype=torch.int32)
                return torch.minimum(d, d[src] + w)
        """)
        assert fs == []

    @pytest.mark.parametrize("snippet", [
        "def f(tau):\n    return tau or 16\n",
        "def f(args):\n    return args.tau or 16\n",
        "def f(tau_solve):\n    return not tau_solve\n",
        "def f(levels):\n    if levels:\n        return 1\n    return 0\n",
        "def f(cfg):\n    while cfg.delta:\n        cfg = None\n",
    ])
    def test_falsy_knob_coercion_flagged(self, snippet):
        assert codes(lint(dtype_lint, snippet)) == ["DTYPE002"]

    def test_explicit_none_comparison_is_clean(self):
        assert lint(dtype_lint, """
            def f(tau, levels):
                t = 16 if tau is None else tau
                if levels > 0:
                    t += levels
                return t
        """) == []


# ---------------------------------------------------------------------------
# determinism-lint
# ---------------------------------------------------------------------------

DECOMP_PATH = "src/repro_torch/core/engine.py"


class TestDeterminismLint:
    @pytest.mark.parametrize("call", [
        "np.random.rand(3)", "random.random()", "np.random.default_rng()",
        "np.random.SeedSequence()", "torch.manual_seed(0)",
        "torch.rand(3)", "torch.randint(0, 4, (3,))", "torch.randperm(5)",
        "torch.randn(2, device=dev)", "torch.empty(3).uniform_()",
        "torch.multinomial(p, 1)",
    ])
    def test_global_rng_flagged_everywhere(self, call):
        fs = lint(determinism_lint, f"""
            import random
            import numpy as np
            import torch

            def f(p, dev):
                return {call}
        """)
        assert codes(fs) == ["DET001"]

    @pytest.mark.parametrize("call", [
        "np.random.default_rng(seed)", "np.random.SeedSequence(seed)",
        "torch.rand(3, generator=g)", "torch.randperm(5, generator=g)",
        "torch.empty(3).uniform_(generator=g)", "torch.Generator()",
    ])
    def test_seeded_draws_are_clean(self, call):
        assert lint(determinism_lint, f"""
            import numpy as np
            import torch

            def f(seed, g):
                return {call}
        """) == []

    def test_wall_clock_flagged_in_clocked_scope(self):
        snippet = """
            import time

            def f():
                return time.perf_counter()
        """
        assert codes(lint(determinism_lint, snippet,
                          path=DECOMP_PATH)) == ["DET002"]
        # every port module is in scope, not just the decomposition set...
        assert codes(lint(determinism_lint, snippet,
                          path="src/repro_torch/launch/serve.py")) == \
            ["DET002"]
        # ...except the sanctioned clock seam itself and files outside
        assert lint(determinism_lint, snippet,
                    path="src/repro_torch/runtime/telemetry.py") == []
        assert lint(determinism_lint, snippet, path="bench.py") == []

    def test_set_iteration_order_flagged_in_decomp_modules(self):
        snippet = """
            import numpy as np

            def f(st):
                dirty = {1, 2, 3}
                a = list(dirty)
                b = np.fromiter(st.dirty_centers, np.int64)
                return a, b
        """
        fs = lint(determinism_lint, snippet, path=DECOMP_PATH)
        assert codes(fs) == ["DET003"] and len(fs) == 2
        assert lint(determinism_lint, snippet,
                    path="src/repro_torch/core/prng.py")
        assert lint(determinism_lint, snippet,
                    path="src/repro_torch/launch/serve.py") == []

    def test_builtin_hash_flagged_in_decomp_modules(self):
        fs = lint(determinism_lint, """
            def f(name):
                return hash(name)
        """, path="src/repro_torch/kernels/edge_relax/ops.py")
        assert codes(fs) == ["DET004"]


# ---------------------------------------------------------------------------
# pragma grammar and the CLI
# ---------------------------------------------------------------------------


ANNOTATED = """
    import torch

    def f(n):
        d = torch.cumsum(torch.ones(n), 0)
        return d.item()  # sync: test corpus, an intentional read
"""


class TestPragmas:
    def test_pragma_suppresses_but_is_reported(self, tmp_path):
        p = tmp_path / "annotated.py"
        p.write_text(textwrap.dedent(ANNOTATED))
        active, suppressed, errors = run_analysis([str(p)])
        assert active == [] and errors == []
        assert codes(suppressed) == ["SYNC002"]

    def test_pragma_on_preceding_line_covers_statement(self, tmp_path):
        p = tmp_path / "annotated.py"
        p.write_text(textwrap.dedent("""
            import torch

            def f(n):
                d = torch.cumsum(torch.ones(n), 0)
                # sync: test corpus, the pragma above the statement
                return d.item()
        """))
        active, suppressed, errors = run_analysis([str(p)])
        assert active == [] and errors == []
        assert codes(suppressed) == ["SYNC002"]

    def test_empty_reason_pragma_is_an_error(self, tmp_path):
        p = tmp_path / "bad.py"
        p.write_text("x = 1  # sync:\n")
        _, _, errors = run_analysis([str(p)])
        assert codes(errors) == ["PRAGMA000"]

    def test_wrong_checker_pragma_does_not_suppress(self, tmp_path):
        p = tmp_path / "wrong.py"
        p.write_text(textwrap.dedent(ANNOTATED.replace("# sync:",
                                                       "# dtype:")))
        active, _, _ = run_analysis([str(p)])
        assert codes(active) == ["SYNC002"]

    def test_cli_exit_status(self, tmp_path, capsys):
        good = tmp_path / "good.py"
        good.write_text(textwrap.dedent(ANNOTATED))
        bad = tmp_path / "bad.py"
        bad.write_text(textwrap.dedent(SYNC_BAD["SYNC002"]))
        empty = tmp_path / "empty.py"
        empty.write_text("x = 1  # det:\n")
        assert analysis_main([str(good)]) == 0
        assert analysis_main([str(good), "-v"]) == 0
        assert "suppressed by pragma" in capsys.readouterr().out
        assert analysis_main([str(bad)]) == 1
        assert analysis_main([str(bad), "--checkers", "dtype,det"]) == 0
        assert analysis_main([str(empty)]) == 1
        with pytest.raises(SystemExit):
            analysis_main([str(good), "--checkers", "pallas"])


def test_repo_src_is_clean():
    """The acceptance contract: the port's tree has no active finding and
    no error, and its intentional reads are pragma-annotated."""
    active, suppressed, errors = run_analysis([PORT_SRC])
    assert [f.format() for f in active] == []
    assert [f.format() for f in errors] == []
    assert suppressed


def test_importing_the_analysis_loads_neither_torch_nor_jax():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__;"
            "repro_torch.analysis.all_checkers();"
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(REPO / "src")})
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# runtime: the meter stack and measured_transfers
# ---------------------------------------------------------------------------


@pytest.fixture
def port_transfer_guarded():
    """The port's ``measured_transfers("disallow")`` region around a test;
    on the CPU it counts, and the sync debug mode is left alone."""
    with guard.measured_transfers("disallow") as meter:
        yield meter


def _graph():
    from repro_torch.graph import generators as gen

    return gen.random_geometric(512, 6.0, seed=1)


class TestTransferGuardEquality:
    def test_stages_measured_equals_counted(self, port_transfer_guarded):
        from repro_torch.core.cluster import cluster

        dec = cluster(_graph(), 4, seed=0, device=CPU)
        m = dec.metrics
        assert port_transfer_guarded.transfers == \
            m.host_syncs + m.finalize_syncs
        assert all(r for r in port_transfer_guarded.reasons())

    def test_oneshot_measured_equals_counted(self, port_transfer_guarded):
        from repro_torch.core.cluster import cluster

        dec = cluster(_graph(), 12, seed=0, mode="oneshot", device=CPU,
                      backend="single")
        m = dec.metrics
        assert port_transfer_guarded.transfers == \
            m.host_syncs + m.finalize_syncs

    def test_checkpointed_decomposition_measured_equals_counted(
            self, tmp_path):
        """With a StageCheckpointer armed, every leaf a save materializes
        goes through guard.fetch and lands in ``checkpoint_syncs``."""
        from repro_torch.core.cluster import cluster
        from repro_torch.core.engine import StageCheckpointer

        ck = StageCheckpointer(str(tmp_path), every=1)
        with guard.measured_transfers() as meter:
            dec = cluster(_graph(), 4, seed=0, checkpointer=ck, device=CPU)
        m = dec.metrics
        assert ck.saves >= 1 and m.checkpoint_syncs > 0
        assert meter.transfers == \
            m.host_syncs + m.finalize_syncs + m.checkpoint_syncs

    @pytest.mark.parametrize("levels", [None, 2])
    def test_pipeline_and_cascade_measured_equals_counted(self, levels):
        from repro_torch.core import (CascadeEstimator,
                                      ClusterQuotientEstimator, open_session)

        est = (ClusterQuotientEstimator() if levels is None
               else CascadeEstimator(levels=levels, tau_solve=16))
        with open_session(_graph(), tau=16 if levels else 12,
                          device=CPU) as sess:
            with guard.measured_transfers() as meter:
                res = sess.estimate(est)
        assert meter.transfers == res.pipeline.total_host_syncs

    @pytest.mark.parametrize("backend", ["single", "kernel"])
    def test_dynamic_update_measured_equals_counted(self, backend):
        from repro_torch.core import UpdateBatch, open_session

        g = _graph()

        def batch(seed):
            r = np.random.default_rng(seed)
            i = r.integers(0, g.n_edges, 4)
            u = r.integers(0, g.n_nodes, 3).astype(np.int32)
            v = r.integers(0, g.n_nodes, 3).astype(np.int32)
            return UpdateBatch(
                insert_src=u, insert_dst=v,
                insert_weight=np.full(3, 5, np.int32),
                reweight_src=g.src[i], reweight_dst=g.dst[i],
                reweight_weight=np.full(4, 7, np.int32))

        with open_session(g, tau=12, backend=backend, device=CPU) as sess:
            sess.apply_updates(batch(0))   # enters dynamic mode
            m = sess.dynamic.metrics
            before = m.update_syncs + m.engine_syncs
            with guard.measured_transfers() as meter:
                sess.apply_updates(batch(1))
            assert meter.transfers == \
                m.update_syncs + m.engine_syncs - before > 0

    def test_fetch_requires_a_reason(self):
        with pytest.raises(ValueError):
            guard.fetch(torch.zeros(3), reason="  ")

    def test_nested_meters_both_count(self):
        with guard.measured_transfers() as outer:
            with guard.measured_transfers() as inner:
                guard.fetch(torch.arange(4), reason="test: nested fetch")
            guard.fetch(torch.arange(2), reason="test: outer-only fetch")
        assert inner.transfers == 1 and outer.transfers == 2
        assert outer.elements == 6

    def test_measured_transfers_levels(self):
        for level in ("disallow", "log", "allow"):
            with guard.measured_transfers(level) as m:
                guard.fetch(torch.arange(3), reason="test: one read")
            assert m.transfers == 1
        with pytest.raises(ValueError):
            with guard.measured_transfers("forbid"):
                pass
        assert guard.active_meter() is None

    def test_meter_stack_survives_an_exception(self):
        with pytest.raises(KeyError):
            with guard.measured_transfers():
                with guard.metered():
                    raise KeyError("inside")
        assert guard.active_meter() is None

    def test_non_lifo_meter_pop_raises_without_popping(self):
        outer = guard.push_meter()
        inner = guard.push_meter()
        with pytest.raises(RuntimeError):
            guard.pop_meter(outer)
        assert guard.active_meter() is inner
        guard.pop_meter(inner)
        guard.pop_meter(outer)
        with pytest.raises(RuntimeError):
            guard.pop_meter(outer)
