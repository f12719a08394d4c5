"""The port's whole paper pipeline against the JAX package: open_session +
ClusterQuotientEstimator with the reference's center draws injected must
give the reference's Phi, radius and cluster count; the interval must
bracket scipy's exact diameter; the package must import neither jax nor
the JAX package; CUDA entry points must raise where there is no GPU."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.sparse.csgraph import shortest_path  # noqa: E402

from repro.core import ClusterQuotientEstimator as RefCQ  # noqa: E402
from repro.core import IntervalEstimator as RefInterval  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch import guard  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ClusterQuotientEstimator,
    IntervalEstimator,
    LowerBoundEstimator,
    open_session,
)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import to_scipy_csr  # noqa: E402
from repro_torch.launch import diameter as launcher  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_SRC = REPO / "src" / "repro_torch"


def jax_uniform_fn(seed: int):
    key = jax.random.PRNGKey(seed)

    def draw(stage, t, n):
        k = jax.random.fold_in(jax.random.fold_in(key, stage), t)
        return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))

    return draw


@pytest.fixture(scope="module")
def road2000():
    return ref_gen.road_like(2000, seed=0), gen.road_like(2000, seed=0)


@pytest.mark.parametrize("backend", ["kernel", "single"])
def test_cluster_quotient_matches_reference(road2000, backend):
    ref_e, e = road2000
    want = RefCQ().estimate(ref_open_session(ref_e))
    session = open_session(e, backend=backend, device="cpu",
                           uniform_fn=jax_uniform_fn(0))
    assert session.tau == 4
    with guard.metered() as meter:
        got = ClusterQuotientEstimator().estimate(session)
    assert (got.phi_approx, got.n_clusters) == (470888, 243)
    for f in ("phi_approx", "phi_quotient", "radius", "n_clusters",
              "growing_steps", "n_stages", "delta_end", "connected"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.quotient_ecc, want.quotient_ecc)
    pm = got.pipeline
    assert pm.n_quotient_edges == want.pipeline.n_quotient_edges
    assert pm.solve_supersteps == want.pipeline.solve_supersteps
    # every host read went through guard.fetch and is counted
    assert meter.transfers == pm.total_host_syncs
    assert pm.quotient_syncs == 1 and pm.finalize_syncs == 1
    assert pm.kernel_launches == 0       # the plain path on the CPU
    assert session.metrics.warm_queries == 1


@pytest.mark.parametrize("graph", ["road", "social"])
def test_interval_brackets_scipy_exact(graph):
    if graph == "road":
        ref_e, e = ref_gen.road_like(2000, seed=0), gen.road_like(2000, seed=0)
    else:
        ref_e, e = ref_gen.social_like(9, seed=2), gen.social_like(9, seed=2)
    got = IntervalEstimator().estimate(
        open_session(e, device="cpu", uniform_fn=jax_uniform_fn(0)))
    exact = int(shortest_path(to_scipy_csr(e), method="D",
                              directed=False).max())
    assert got.connected and got.lower <= exact <= got.upper
    want = RefInterval().estimate(ref_open_session(ref_e))
    assert (got.lower, got.upper) == (want.lower, want.upper)
    if graph == "road":
        assert (got.lower, got.upper) == (447564, 451028)
        assert exact == 447564


def test_lower_bound_and_default_draw_on_heavy_path():
    n = 6
    u = np.arange(n - 1, dtype=np.int32)
    e = gen.EdgeList.from_undirected(n, u, u + 1,
                                     np.full(n - 1, 2**30 - 1, np.int32))
    s = open_session(e, tau=1, device="cpu")
    lb = LowerBoundEstimator(rounds=2).estimate(s)
    assert lb.lower == 5 * (2**30 - 1) and lb.connected
    iv = IntervalEstimator().estimate(s)
    assert iv.lower == 5 * (2**30 - 1) <= iv.upper


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted(PORT_SRC.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_entry_points_raise_without_gpu(road2000):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, e = road2000
    with pytest.raises(RuntimeError, match="cuda"):
        open_session(e)
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--n", "100"])


def test_launcher_runs_on_cpu(capsys):
    assert launcher.main(["--graph", "road", "--n", "600", "--tau", "4",
                          "--device", "cpu", "--interval"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 600 and out["lower"] <= out["upper"]
    assert out["phi_approx"] >= out["upper"] and out["host_syncs"] > 0


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = _run_smoke(REPO)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    # alone in a directory, without the program, it must fail too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
