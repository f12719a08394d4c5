"""The LM family beyond gemma2-9b on the port, against the JAX package:
mistral-nemo-12b, qwen1.5-32b (QKV bias), and the MoE archs
moonshot-v1-16b-a3b and mixtral-8x7b (a window on every layer). Their
configs and the registry, ``LM_SHAPES``, ``_lm_model_flops`` and
``LMTokenPipeline``; ``prefill_step`` and 12 ``decode_step``s of each smoke
model with the reference's own weights (carried over by
``transformer_params_from_reference``); ``build_cell``'s ``prefill_32k``
and ``decode_32k`` cells at smoke width (batch and length cut) against the
reference's ``prefill_step`` and ``decode_step`` at ``len = S - 1``; the
serve CLI on each smoke arch.

Tolerances:
  * float32: 1e-4 absolute and relative on the logits (|logits| < 6) and
    the cache, as ``test_torch_transformer.py``: the same arithmetic, sums
    in another order, XLA's and torch's float32 transcendental functions
    a last ulp apart.
  * bfloat16 (the dense archs): relative L2 under 3e-2 over all logits and
    every logit within 3e-2 of the largest |logit|. Every matmul output,
    norm output and residual add is rounded to bf16 (a relative step of
    2^-8) at other places in the two frameworks; measured on the CPU, the
    two sides are 1.1-1.2% apart (relative L2) and at most 1.7% of the
    largest logit. The MoE archs are held in bf16 layer by layer
    (``test_torch_moe.py``): a router near-tie that the two frameworks'
    bf16 roundings break differently sends a token to another expert and,
    through attention, moves every later token (the mixtral smoke model at
    seed 2: 16 of 80 logit rows more than 3% apart), so a whole-model bf16
    rule would have to allow any difference at all.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import json

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config import base as ref_base  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch.steps import _lm_model_flops as ref_model_flops  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.config import (LM_SHAPES, MoEConfig, get_arch,  # noqa: E402
                                list_archs, shapes_for_family)
from repro_torch.convert import transformer_params_from_reference  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import _lm_model_flops, build_cell  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_L2, BF16_MAX_SHARE = 3e-2, 3e-2
ARCHS = ("mistral-nemo-12b", "qwen1.5-32b", "moonshot-v1-16b-a3b",
         "mixtral-8x7b")
DENSE = ARCHS[:2]
# the reference's param_count() at full width, and what init_params makes
PARAM_COUNTS = {"mistral-nemo-12b": 12_247_782_400,
                "qwen1.5-32b": 35_196_113_920,
                "moonshot-v1-16b-a3b": 28_888_467_456,
                "mixtral-8x7b": 46_702_792_704}
QWEN_BIASES = 64 * 3 * 5120        # bq, bk, bv: left out of param_count()
SHAPES = {s.name: s for s in LM_SHAPES}


def _setup(arch, dtype="float32", seed=1):
    ref_cfg = dataclasses.replace(ref_get_arch(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype=dtype)
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = transformer_params_from_reference(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, cfg, ref_params, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_registry_match_the_reference(arch):
    for smoke in (False, True):
        ref, got = ref_get_arch(arch, smoke=smoke), get_arch(arch,
                                                              smoke=smoke)
        assert type(got).__name__ == type(ref).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
        if isinstance(got, MoEConfig):
            assert got.active_param_count() == ref.active_param_count()
    cfg = get_arch(arch)
    assert cfg.param_count() == PARAM_COUNTS[arch]
    assert cfg.head_dim == 128
    assert arch in list_archs() and "gemma2-9b" in list_archs()
    if arch == "qwen1.5-32b":
        # what init_params makes: the biases on top of param_count()
        assert cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            * cfg.head_dim == QWEN_BIASES == 983_040


def test_shapes_and_model_flops_match_the_reference():
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in ref_base.LM_SHAPES]
    assert shapes_for_family("lm") == LM_SHAPES
    for arch in ("gemma2-9b",) + ARCHS:
        cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
        for shape, ref_shape in zip(LM_SHAPES, ref_base.LM_SHAPES):
            for kind in ("train", "prefill", "decode"):
                assert _lm_model_flops(cfg, shape, kind) == \
                    ref_model_flops(ref_cfg, ref_shape, kind)


def test_lm_token_pipeline_batches_equal_reference():
    cfg = get_arch("mistral-nemo-12b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=512,
                                global_batch=4)
    ref_shape = dataclasses.replace(ref_base.LM_SHAPES[0], seq_len=512,
                                    global_batch=4)
    for seed in (0, 3):
        got = pipeline.LMTokenPipeline(cfg, shape, n_hosts=2, seed=seed)
        want = ref_pipeline.LMTokenPipeline(ref_get_arch("mistral-nemo-12b"),
                                            ref_shape, n_hosts=2, seed=seed)
        assert got.n_shards == want.n_shards == 8
        for step, shard in ((0, 0), (3, 1), (7, 5)):
            a = got.batch(pipeline.DataCursor(step=step, shard=shard))
            b = want.batch(ref_pipeline.DataCursor(step=step, shard=shard))
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        first = [next(iter(got))["tokens"], next(iter(want))["tokens"]]
        np.testing.assert_array_equal(*first)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    ref_cfg, cfg, ref_params, params = _setup(arch)
    toks = _tokens(cfg, 2, 40)          # past mixtral's window of 16
    want = np.asarray(ref_tf.prefill_step(ref_params, jnp.asarray(toks),
                                          ref_cfg, attn_impl="ref"))
    before = flash_attention_cuda.launches
    got = tf.prefill_step(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert flash_attention_cuda.launches == before   # plain path on the CPU
    _, want_aux = ref_tf.forward_hidden(ref_params, jnp.asarray(toks),
                                        ref_cfg, attn_impl="ref")
    _, aux = tf.forward_hidden(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)
    assert (float(aux) > 0) == isinstance(cfg, MoEConfig)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """12 decode steps from an empty cache (mixtral's window of 16 is not
    reached; the cells' test below decodes past it)."""
    ref_cfg, cfg, ref_params, params = _setup(arch, seed=2)
    B, steps, max_len = 2, 12, 16
    toks = _tokens(cfg, B, steps, seed=5)
    ref_cache = ref_tf.init_cache(ref_cfg, B, max_len)
    cache = tf.init_cache(cfg, B, max_len, device="cpu")
    for i in range(steps):
        want, ref_cache = ref_tf.decode_step(
            ref_params, ref_cache, jnp.asarray(toks[:, i:i + 1]), ref_cfg)
        got, cache = tf.decode_step(params, cache,
                                    torch.from_numpy(toks[:, i:i + 1]), cfg)
        assert tuple(got.shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL,
                                   err_msg=f"step {i}")
    assert cache["len"] == int(ref_cache["len"]) == steps
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), **F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_bf16_matches_reference(arch):
    ref_cfg, cfg, ref_params, params = _setup(arch, "bfloat16", seed=3)
    toks = _tokens(cfg, 2, 40, seed=3)
    want = np.asarray(ref_tf.prefill_step(ref_params, jnp.asarray(toks),
                                          ref_cfg, attn_impl="ref"))
    got = tf.prefill_step(params, torch.from_numpy(toks), cfg).numpy()
    assert np.isfinite(got).all()
    assert _rel_l2(got, want) < BF16_REL_L2
    assert np.abs(got - want).max() < BF16_MAX_SHARE * np.abs(want).max()


def _filled_cache(cfg, B, S, seed):
    r = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    return {name: r.standard_normal(shape).astype(np.float32)
            for name in ("k", "v")}


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch, kind):
    """The cells at smoke width, batch 2 and length 24 (past mixtral's
    window), with the MoE dispatch in one group as on one device: prefill
    on ``LMTokenPipeline``'s tokens, decode of one token against a cache of
    24 seeded positions at ``len`` 23."""
    ref_cfg, _, ref_params, params = _setup(arch, seed=4)
    B, S = 2, 24
    cell = build_cell(arch, kind, smoke=True, device="cpu", batch=B,
                      seq_len=S)
    cfg = cell.cfg
    assert cell.arch == cfg.name and cell.shape == kind
    assert getattr(cfg, "moe_groups", 1) == 1
    assert f"batch {B} of {SHAPES[kind].global_batch}" in cell.note
    assert f"seq_len {S} of 32768" in cell.note
    cut = dataclasses.replace(SHAPES[kind], global_batch=B, seq_len=S)
    ref_cut = dataclasses.replace(
        {s.name: s for s in ref_base.LM_SHAPES}[kind], global_batch=B,
        seq_len=S)
    kind_ = cut.kind
    assert cell.model_flops == ref_model_flops(ref_cfg, ref_cut, kind_)
    if kind_ == "prefill":
        batch = pipeline.LMTokenPipeline(cfg, cut, seed=0).batch(
            pipeline.DataCursor())
        inputs = cell.inputs(batch)
        assert tuple(inputs["tokens"].shape) == cell.arg_shapes["tokens"][0]
        got = cell.step_fn(params, inputs)
        want = ref_tf.prefill_step(ref_params, jnp.asarray(batch["tokens"]),
                                   ref_cfg, attn_impl="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        return
    arrays = _filled_cache(cfg, B, S, seed=6)
    tok = _tokens(cfg, B, 1, seed=7)
    assert cell.arg_shapes["k"][0] == arrays["k"].shape
    assert cell.arg_shapes["tok"][0] == tok.shape
    cache = {name: torch.from_numpy(a.copy()) for name, a in arrays.items()}
    cache["len"] = 0          # the step sets it to S - 1
    logits, new_cache = cell.step_fn(params, cache, torch.from_numpy(tok))
    ref_cache = {name: jnp.asarray(a) for name, a in arrays.items()}
    ref_cache["len"] = jnp.int32(S - 1)
    want, want_cache = ref_tf.decode_step(ref_params, ref_cache,
                                          jnp.asarray(tok), ref_cfg)
    assert new_cache["len"] == int(want_cache["len"]) == S
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(new_cache[name].numpy(),
                                   np.asarray(want_cache[name]), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_raises_and_cell_arguments_are_checked(arch):
    """Every arch's train_4k is the training cell (tokens and labels at
    the shape's batch and length; an MoE arch's in one dispatch group,
    its FLOPs from the active parameters); wrong cell arguments raise."""
    cell = build_cell(arch, "train_4k", smoke=True, device="cpu")
    assert cell.arg_shapes == {"tokens": ((256, 4096), torch.int32),
                               "labels": ((256, 4096), torch.int32)}
    assert cell.note == "" and cell.model_flops == _lm_model_flops(
        cell.cfg, SHAPES["train_4k"], "train")
    if arch not in DENSE:
        assert cell.cfg.moe_groups == 1
        assert cell.model_flops == 6.0 * cell.cfg.active_param_count() \
            * 256 * 4096
    with pytest.raises(TypeError, match="n_nodes"):
        build_cell(arch, "prefill_32k", smoke=True, device="cpu",
                   n_nodes=8)
    cell = build_cell(arch, "decode_32k", smoke=True, device="cpu")
    assert cell.note == "decode against 32768-token cache"
    assert cell.arg_shapes["tok"][0] == (128, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_cell(arch, "prefill_32k", smoke=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_smoke_arch(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "5"]
    assert serve.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_arch(arch, smoke=True)
    assert res["arch"] == cfg.name and res["logits_finite"]
    assert res["params"] == cfg.param_count()
    assert len(res["ids0"]) == 5
    assert all(0 <= t < cfg.vocab_size for t in res["ids0"])
    assert res["prefill_tok_s"] > 0 and res["decode_tok_s"] > 0
    again = serve.serve_lm(serve.parse_args(argv))["ids"]
    assert again[0].tolist() == res["ids0"]         # seeded: reproducible
