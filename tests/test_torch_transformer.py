"""The port's dense transformer (``repro_torch/models/transformer.py``) and
LM serving launcher against the JAX package's, on the gemma2-9b smoke
config (4 layers, d_model 64, GQA 4/2, head_dim 16, window 16 on the even
layers, softcaps 50 and 30, GeGLU, tied embeddings): the reference's own
weights are carried over with ``transformer_params_from_reference``, then
``prefill_step`` at S = 40 (past the window) is held to the reference's
``prefill_step`` with ``attn_impl="ref"`` and ``"interpret"`` (its Pallas
kernel), and 12 ``decode_step``s to the reference's, logits at every step
and the final cache. Also the configs and registry, the parameter
converter, ``init_params`` and the serve CLI.

Tolerances:
  * float32: 1e-4 absolute and relative on the logits (|logits| < 30).
    Both sides compute in float32 through four layers; the sums run in
    another order (matmuls, attention), and XLA's and torch's float32
    pow, cos, sin, tanh and rsqrt may differ in the last ulp.
  * bfloat16: 2e-2 absolute on the logits (|logits| < 1 here), 3e-2
    relative L2. Every matmul output, norm output and residual add is
    rounded to bf16 (8 significant bits, a relative step of 2^-8 = 0.4%),
    at other places in the two frameworks (XLA fuses elementwise chains
    and rounds once). Measured on the CPU: each side's logits are 1.1%
    (relative L2) from a float32 run of the same bf16 weights, and the
    two sides 1.1-1.2% from each other, with a largest difference of
    0.012 over four token draws.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import json

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.config.registry import list_archs as ref_list_archs  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.config import get_arch, list_archs  # noqa: E402
from repro_torch.convert import transformer_params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_REL_L2 = 2e-2, 3e-2
S_PREFILL = 40


def _configs(dtype="float32", **overrides):
    ref_cfg = dataclasses.replace(ref_get_arch("gemma2-9b", smoke=True),
                                  dtype=dtype, **overrides)
    cfg = dataclasses.replace(get_arch("gemma2-9b", smoke=True),
                              dtype=dtype, **overrides)
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=1):
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, ref_params)
    return ref_params, transformer_params_from_reference(params_np, cfg,
                                                         device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_configs_and_registry_match_the_reference():
    for smoke in (False, True):
        want = dataclasses.asdict(ref_get_arch("gemma2-9b", smoke=smoke))
        assert dataclasses.asdict(get_arch("gemma2-9b", smoke=smoke)) == want
    cfg = get_arch("gemma2-9b")
    assert cfg.param_count() == 9_241_404_928 == \
        ref_get_arch("gemma2-9b").param_count()
    assert cfg.head_dim == 256
    assert list_archs() == ("equiformer-v2", "gatedgcn", "gcn-cora",
                            "gemma2-9b", "meshgraphnet", "mistral-nemo-12b",
                            "mixtral-8x7b", "moonshot-v1-16b-a3b",
                            "paper-graph", "qwen1.5-32b", "xdeepfm")
    assert list_archs() == ref_list_archs()
    # a name the reference does not register either
    with pytest.raises(KeyError, match="gemma2-9b"):
        get_arch("llama-7b")
    with pytest.raises(KeyError):
        ref_get_arch("llama-7b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_over_bit_for_bit(dtype):
    ref_cfg, cfg = _configs(dtype)
    ref_params, params = _params(ref_cfg, cfg)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    assert len(flat_ref) == sum(
        len(v) if isinstance(v, dict) else 1 for v in params.values())
    for path, leaf in flat_ref:
        keys = [p.key for p in path]
        t = params[keys[0]] if len(keys) == 1 else params[keys[0]][keys[1]]
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == leaf.shape
        want = np.asarray(leaf).view(np.uint16 if dtype == "bfloat16"
                                     else np.uint32)
        got = t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        np.testing.assert_array_equal(got.numpy().view(want.dtype), want)
    with pytest.raises(ValueError, match="float32"):
        transformer_params_from_reference(
            jax.tree.map(np.asarray, ref_params),
            dataclasses.replace(cfg, dtype="float32" if dtype == "bfloat16"
                                else "bfloat16"), device="cpu")


@pytest.mark.parametrize("attn_impl", ["ref", "interpret"])
def test_prefill_matches_reference(attn_impl):
    ref_cfg, cfg = _configs()
    ref_params, params = _params(ref_cfg, cfg)
    toks = _tokens(cfg, 2, S_PREFILL)
    want = np.asarray(ref_tf.prefill_step(ref_params, jnp.asarray(toks),
                                          ref_cfg, attn_impl=attn_impl))
    before = flash_attention_cuda.launches
    got = tf.prefill_step(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, S_PREFILL, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert flash_attention_cuda.launches == before   # plain path on the CPU


def test_prefill_bf16_matches_reference():
    ref_cfg, cfg = _configs("bfloat16")
    ref_params, params = _params(ref_cfg, cfg)
    toks = _tokens(cfg, 2, S_PREFILL, seed=3)
    want = np.asarray(ref_tf.prefill_step(ref_params, jnp.asarray(toks),
                                          ref_cfg, attn_impl="ref"))
    got = tf.prefill_step(params, torch.from_numpy(toks), cfg).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < BF16_ATOL
    assert _rel_l2(got, want) < BF16_REL_L2


@pytest.mark.parametrize("window", [16, 4])
def test_decode_steps_match_reference(window):
    """12 decode steps from an empty cache; at window 4 the even layers'
    window masks the cache from the fifth step on."""
    ref_cfg, cfg = _configs(sliding_window=window)
    ref_params, params = _params(ref_cfg, cfg)
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


def test_chunk_into_cache_matches_reference():
    """An attention block writing a chunk of 6 positions into a cache that
    already holds 10 (the kernel's q_offset / kv_len path inside a layer)."""
    ref_cfg, cfg = _configs(sliding_window=8)
    ref_params, params = _params(ref_cfg, cfg)
    r = np.random.default_rng(7)
    B, S, start, max_len = 2, 6, 10, 20
    x = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    shape = (B, cfg.n_kv_heads, max_len, cfg.head_dim)
    ck, cv = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.arange(start, start + S, dtype=np.int32)
    ref_lp = jax.tree.map(lambda a: a[0], ref_params["layers"])
    want, (wk, wv) = ref_tf._attention_block(
        jnp.asarray(x), ref_lp, ref_cfg, jnp.asarray(pos),
        jnp.int32(start + S), 8, cache_kv=(jnp.asarray(ck), jnp.asarray(cv)),
        attn_impl="ref")
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = tf._attention_block(
        torch.from_numpy(x), tf.layer_params(params, 0), cfg,
        torch.from_numpy(pos), start + S, 8, cache_kv=(tck, tcv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **F32_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **F32_TOL)
    assert gk.data_ptr() == tck.data_ptr()        # written in place


def test_init_params_shapes_scale_and_device():
    cfg = get_arch("gemma2-9b", smoke=True)
    p = tf.init_params(cfg, seed=0, device="cpu")
    ref_shapes = jax.tree.map(
        lambda a: a.shape,
        jax.eval_shape(lambda: ref_tf.init_params(
            ref_get_arch("gemma2-9b", smoke=True), jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == \
        ref_shapes["layers"]
    assert tuple(p["embed"].shape) == ref_shapes["embed"]
    n = sum(v.numel() for v in p["layers"].values()) + p["embed"].numel() \
        + p["final_norm"].numel()
    assert n == cfg.param_count()
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["layers"]["w_down"].std()) - cfg.d_ff ** -0.5) < 2e-3
    q = tf.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["layers"]["wq"], q["layers"]["wq"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tf.init_params(cfg)


def test_serve_cli_smoke_runs_end_to_end(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "5"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["arch"] == "gemma2-9b-smoke" and res["logits_finite"]
    assert len(res["ids0"]) == 5
    assert all(0 <= t < 512 for t in res["ids0"])
    assert res["prefill_tok_s"] > 0 and res["decode_tok_s"] > 0
    args = serve.parse_args(["--smoke", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--gen", "5"])
    again = serve.serve_lm(args)["ids"]
    assert again[0].tolist() == res["ids0"]         # seeded: reproducible
    sampled = serve.serve_lm(serve.parse_args(
        ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
         "--gen", "3", "--temperature", "0.8"]))
    assert tuple(sampled["ids"].shape) == (2, 3)


def test_serve_cli_rejects_what_is_not_ported():
    # graph-diameter serving and its dynamic updates are ported; the JAX
    # package's recorded host reads are not the port's
    for argv in (["--mode", "graph-diameter", "--sync-budget", "bench"],
                 ["--mode", "recsys"]):
        with pytest.raises(SystemExit) as e:
            serve.parse_args(argv)
        assert e.value.code == 2
    with pytest.raises(SystemExit):
        serve.parse_args(["--gen", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.serve_lm(serve.parse_args(["--smoke"]))
