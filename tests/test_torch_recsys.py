"""The port's xDeepFM serving slice against the JAX package's: the configs,
registry and ``param_count``; ``RecsysPipeline`` batches; the parameter
converter; ``embedding_bag``; ``forward`` and ``retrieval_scores`` with the
reference's own weights (carried over with
``recsys_params_from_reference``) against the reference's with
``cin_impl="ref"`` and ``"interpret"`` (its Pallas CIN kernel), on the
smoke config and on xdeepfm's full widths (39 fields, embed dim 10, CIN
200-200-200, DNN 400-400) with only ``vocab_per_field`` cut from 1,000,000
to 1,000 (the tables' size, 1.56 GB, is the one cut); ``init_params``; and
``launch/steps.py``'s ``build_cell``.

Tolerances:
  * ``embedding_bag``: bit equality. Both sides gather the same float32
    rows, multiply by the same mask, add at most two rows starting from
    zero (exact in either order) and divide by the same count.
  * logits: 1e-6 absolute and 1e-5 relative (|logits| < 1 here). The
    linear branch sums 39 terms and the DNN's matmuls sum 403 and 400, in
    another order than XLA's; the CIN branch adds about 1e-4. Measured:
    at most 4e-8 apart.
  * the CIN pooled features: the float32 rule of ``kernels/cin/cases.py``
    (``2^-16`` of the stack run on absolute values).
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import RECSYS_SHAPES as REF_RECSYS_SHAPES  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data.pipeline import DataCursor as RefDataCursor  # noqa: E402
from repro.data.pipeline import RecsysPipeline as RefRecsysPipeline  # noqa: E402
from repro.kernels.cin.ref import cin_ref as ref_cin_ref  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro_torch.config import RECSYS_SHAPES, get_arch, list_archs  # noqa: E402
from repro_torch.convert import recsys_params_from_reference  # noqa: E402
from repro_torch.data.pipeline import DataCursor, RecsysPipeline  # noqa: E402
from repro_torch.kernels.cin import kernel as cmod  # noqa: E402
from repro_torch.kernels.cin.cases import excess, pooled_magnitude  # noqa: E402
from repro_torch.kernels.cin.ops import cin  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import recsys  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
FULL_VOCAB_CUT = 1000


def _configs(full: bool):
    ref_cfg = ref_get_arch("xdeepfm", smoke=not full)
    cfg = get_arch("xdeepfm", smoke=not full)
    if full:
        ref_cfg = dataclasses.replace(ref_cfg, vocab_per_field=FULL_VOCAB_CUT)
        cfg = dataclasses.replace(cfg, vocab_per_field=FULL_VOCAB_CUT)
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=1):
    ref_params = ref_rs.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, ref_params)
    return ref_params, recsys_params_from_reference(params_np, cfg,
                                                    device="cpu")


def _batch(ref_cfg, B, step=0):
    """A pipeline batch of B rows with some ids masked out (row 0's first
    field entirely; with bag 2, row 1's second id of every field)."""
    shape = dataclasses.replace(REF_RECSYS_SHAPES[1], batch=B)
    b = RefRecsysPipeline(ref_cfg, shape, seed=3).batch(
        RefDataCursor(step=step))
    b["id_mask"][0, 0, :] = 0
    if B > 1 and b["ids"].shape[2] > 1:
        b["id_mask"][1, :, 1] = 0
    return b


def test_configs_registry_and_param_count_match_reference():
    assert "xdeepfm" in list_archs()
    for smoke in (False, True):
        ref, got = (ref_get_arch("xdeepfm", smoke=smoke),
                    get_arch("xdeepfm", smoke=smoke))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
    assert get_arch("xdeepfm").param_count() == 393_747_201
    # the port's ShapeSpec keeps the fields the recsys shapes set; the
    # reference's others stay at their defaults on these shapes
    kept = [f.name for f in dataclasses.fields(RECSYS_SHAPES[0])]
    ref_shapes = [dataclasses.asdict(s) for s in REF_RECSYS_SHAPES]
    assert ([dataclasses.asdict(s) for s in RECSYS_SHAPES]
            == [{k: s[k] for k in kept} for s in ref_shapes])
    unset = dataclasses.asdict(REF_RECSYS_SHAPES[0].__class__("", ""))
    assert all(s[k] == unset[k] for s in ref_shapes for k in s
               if k not in kept)


@pytest.mark.parametrize("full", [False, True])
def test_pipeline_batches_equal_reference(full):
    ref_cfg, cfg = _configs(full)
    for shape_i in (1, 3):
        ref_shape = dataclasses.replace(REF_RECSYS_SHAPES[shape_i], batch=64)
        shape = dataclasses.replace(RECSYS_SHAPES[shape_i], batch=64)
        for step, shard in ((0, 0), (5, 2)):
            want = RefRecsysPipeline(ref_cfg, ref_shape, seed=7).batch(
                RefDataCursor(step=step, shard=shard))
            got = RecsysPipeline(cfg, shape, seed=7).batch(
                DataCursor(step=step, shard=shard))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_params_round_trip_and_reject_mismatches():
    ref_cfg, cfg = _configs(False)
    ref_params, params = _params(ref_cfg, cfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    assert sorted(params) == sorted(ref_params)
    for path, leaf in flat_ref:
        node = params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    params_np = jax.tree.map(np.asarray, ref_params)
    with pytest.raises(ValueError, match="tables"):
        recsys_params_from_reference(
            {**params_np, "tables": params_np["tables"][:, :10]}, cfg,
            device="cpu")
    with pytest.raises(ValueError, match="float32"):
        recsys_params_from_reference(
            {**params_np, "bias": np.zeros((), np.float64)}, cfg,
            device="cpu")
    with pytest.raises(ValueError, match="layer counts"):
        recsys_params_from_reference(
            {**params_np, "cin": params_np["cin"][:1]}, cfg, device="cpu")


def test_embedding_bag_equals_reference_bitwise():
    """Bag 2 (the smoke config) with row 0's first field masked out and row
    1's second ids masked out, under both combiners."""
    ref_cfg, cfg = _configs(False)
    ref_params, params = _params(ref_cfg, cfg)
    b = _batch(ref_cfg, 32)
    assert b["ids"].shape[2] == 2
    for combiner in ("mean", "sum"):
        want = np.asarray(jax.vmap(
            lambda t, i, m: ref_rs.embedding_bag(t, i, m, combiner=combiner),
            in_axes=(0, 1, 1), out_axes=1)(
                ref_params["tables"], jnp.asarray(b["ids"]),
                jnp.asarray(b["id_mask"])))
        got = recsys.embedding_bag(params["tables"],
                                   torch.from_numpy(b["ids"]),
                                   torch.from_numpy(b["id_mask"]),
                                   combiner=combiner).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == 0).all()


@pytest.mark.parametrize("cin_impl", ["ref", "interpret"])
@pytest.mark.parametrize("full", [False, True])
def test_forward_matches_reference(full, cin_impl):
    ref_cfg, cfg = _configs(full)
    ref_params, params = _params(ref_cfg, cfg)
    b = _batch(ref_cfg, 24, step=1)
    want = np.asarray(ref_rs.forward(
        ref_params, {k: jnp.asarray(v) for k, v in b.items()}, ref_cfg,
        cin_impl=cin_impl))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = recsys.forward(params, tb, cfg).numpy()
    assert got.shape == (24,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(
        recsys.forward(params, tb, cfg, cin_impl="ref").numpy(), got)
    # the CIN features themselves, which move the logits by about 1e-4 only
    emb = recsys.embedding_bag(params["tables"], tb["ids"], tb["id_mask"])
    want_pooled = torch.from_numpy(np.asarray(ref_cin_ref(
        jnp.asarray(emb.numpy()), ref_params["cin"])))
    assert excess(cin(emb, params["cin"]), want_pooled,
                  pooled_magnitude(emb, params["cin"])) <= 1.0


@pytest.mark.parametrize("cin_impl", ["ref", "interpret"])
@pytest.mark.parametrize("full", [False, True])
def test_retrieval_scores_match_reference(full, cin_impl):
    """One query against 40 candidates, ``n_sparse // 3`` user fields and the
    rest item fields (13 and 26 at full width, 2 and 4 in the smoke
    config), as ``build_cell`` splits them."""
    ref_cfg, cfg = _configs(full)
    ref_params, params = _params(ref_cfg, cfg)
    fu = cfg.n_sparse // 3
    q = _batch(ref_cfg, 1, step=2)
    c = _batch(ref_cfg, 40, step=3)
    args = (q["ids"][:, :fu], q["id_mask"][:, :fu], q["dense"],
            c["ids"][:, fu:], c["id_mask"][:, fu:])
    want = np.asarray(ref_rs.retrieval_scores(
        ref_params, *map(jnp.asarray, args), ref_cfg, cin_impl=cin_impl))
    got = recsys.retrieval_scores(params, *map(torch.from_numpy, args),
                                  cfg).numpy()
    assert got.shape == (40,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_init_params_shapes_and_scales():
    cfg = get_arch("xdeepfm", smoke=True)
    p = recsys.init_params(cfg, seed=0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: ref_rs.init_params(ref_get_arch("xdeepfm", smoke=True), k),
        jax.random.PRNGKey(0)))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got_shapes == jax.tree.map(tuple, ref_shapes,
                                      is_leaf=lambda x: isinstance(x, tuple))
    n = sum(t.numel() for t in jax.tree.leaves(p))
    # the reference's count leaves out the linear table and the last MLP
    # layer's one bias
    assert n == cfg.param_count() + cfg.n_sparse * cfg.vocab_per_field + 1
    assert abs(float(p["tables"].std()) - 0.01) < 1e-3
    w0 = p["cin"][0]
    assert abs(float(w0.std()) - (6 * 6) ** -0.5) < 0.05 * (6 * 6) ** -0.5
    assert float(p["bias"]) == 0.0
    q = recsys.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["tables"], q["tables"])
    assert not torch.equal(p["tables"], recsys.init_params(
        cfg, seed=1, device="cpu")["tables"])


def test_build_cell_runs_both_serving_kinds_on_cpu():
    cfg = get_arch("xdeepfm", smoke=True)
    params = recsys.init_params(cfg, seed=0, device="cpu")
    cell = build_cell("xdeepfm", "serve_p99", smoke=True, device="cpu")
    assert cell.arg_shapes["ids"] == ((512, 6, 2), torch.int32)
    b = RecsysPipeline(cfg, RECSYS_SHAPES[1], seed=0).batch(DataCursor())
    inputs = cell.inputs(b)
    assert sorted(inputs) == ["dense", "id_mask", "ids"]
    before = cmod.cin_layer_cuda.launches
    logits = cell.step_fn(params, inputs)
    assert logits.shape == (512,) and torch.isfinite(logits).all()
    assert cmod.cin_layer_cuda.launches == before
    torch.testing.assert_close(logits, recsys.forward(params, inputs, cfg),
                               rtol=0, atol=0)

    cell = build_cell("xdeepfm", "retrieval_cand", smoke=True, device="cpu")
    assert cell.cfg.n_sparse == 6 and cell.note == "1 query x 1000000 candidates"
    assert cell.arg_shapes["cand_ids"] == ((1_000_000, 4, 2), torch.int32)
    assert cell.arg_shapes["user_ids"] == ((1, 2, 2), torch.int32)
    r = np.random.default_rng(0)
    q = {"user_ids": b["ids"][:1, :2], "user_mask": b["id_mask"][:1, :2],
         "user_dense": b["dense"][:1],
         "cand_ids": r.integers(0, 1000, (64, 4, 2)).astype(np.int32),
         "cand_mask": np.ones((64, 4, 2), np.float32)}
    scores = cell.step_fn(params, cell.inputs(q))
    assert scores.shape == (64,) and torch.isfinite(scores).all()
    # candidate 0 with row 0's item fields scores as row 0 does
    q["cand_ids"][0] = b["ids"][0, 2:]
    q["cand_mask"][0] = b["id_mask"][0, 2:]
    scores = cell.step_fn(params, cell.inputs(q), cin_impl="ref")
    torch.testing.assert_close(scores[0], logits[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch,shape", [("xdeepfm", "molecule"),
                                        ("gemma2-9b", "no_such_shape"),
                                        ("gcn-cora", "no_such_shape"),
                                        ("xdeepfm", "no_such_shape"),
                                        ("gatedgcn", "serve_p99")])
def test_build_cell_raises_for_what_is_not_ported(arch, shape):
    """A family or kind the port lacks raises NotImplementedError naming
    the ported kinds and the family and kind asked for (shapes an arch's
    family does not have: an unknown LM shape, a GNN shape of xdeepfm,
    whose train_batch is ported with its serving shapes, and a recsys
    shape of a GNN arch, whose four shapes are ported as training
    cells)."""
    match = (f"{arch} x {shape} is not ported; the port builds the recsys "
             f"family's recsys_train, recsys_serve, retrieval shapes, the lm "
             f"family's train, prefill, decode shapes and the gnn family's "
             f"full_graph, minibatch, batched_graphs shapes")
    with pytest.raises(NotImplementedError, match=match) as err:
        build_cell(arch, shape, smoke=True, device="cpu")
    if arch in ("gcn-cora", "gatedgcn"):
        assert "the gnn family's unknown kind" in str(err.value)
    if arch == "gemma2-9b":
        assert "the lm family's unknown kind" in str(err.value)
