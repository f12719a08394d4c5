"""The port's LM training path against the JAX package's:
``models/transformer.lm_loss`` (chunked over the sequence, each chunk's
logits recomputed in the backward) and its gradients by autograd against
``jax.value_and_grad`` of the reference's ``lm_loss``, at gemma2-9b's,
mistral-nemo-12b's and qwen1.5-32b's smoke configs (qwen's QKV biases
drawn non-zero), four loss chunks and masked labels, in
float64 (the reference's weights carried over with
``convert.transformer_params_from_reference``); remat on and off; an MoE
smoke arch's loss; three AdamW steps on a bf16 tree; the int8
error-feedback codec; the ``train_4k`` cell; and ``launch/train.py`` on
the CPU (an interrupted run resumed equals an uninterrupted one).

The reference computes its attention, norms, rotary angles and logits in
float32 whatever its inputs (``astype(jnp.float32)``), so here its
``transformer`` and attention modules run with ``jnp.float32`` read as
``jnp.float64`` (``reference_in_float64``, as in
``tests/test_torch_flash_backward.py``; its ``int32`` read as ``int64``,
without which its chunked loss does not trace under x64); the port
computes those in ``promote_types(dtype, float32)``, float64 here.

Tolerances:
  * float64 loss and every gradient leaf: 1e-9 of the leaf's largest
    magnitude (sums in other orders differ by about 1e-15 relative);
  * remat on and off: bit for bit (the same operations, recomputed);
  * AdamW on bf16 parameters, gradients of global norm under the clip
    norm (clipped ones move every element with the norm's float32 sum
    order, which ``tests/test_torch_adamw.py`` covers): m and v within
    ``REL`` (2^-22, two float32 ulps) of the leaf's largest magnitude,
    the bf16 parameters within one bf16 ulp of each element (a float32
    result an ulp away may round to the other side of a bf16 boundary);
  * the int8 codec: bit for bit.
"""
import torch_testing  # first: one thread, the x64 shim

import dataclasses
import functools
import json

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.runtime import compression as ref_comp  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.config import TrainConfig, get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_reference  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402

TOL = 1e-9
REL = 2.0 ** -22
B, S, CHUNKS = 2, 32, 4


# under x64 the loss's chunk scan sums an int64 mask count into its
# ``jnp.int32(0)`` carry, which JAX refuses: int32 is read as int64 too
reference_in_float64 = functools.partial(torch_testing.reference_in_float64,
                                         wide_ints=True)


def _batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 5:9] = -1          # masked positions inside a chunk
    return {"tokens": toks, "labels": labels}


def _setup(arch):
    ref_cfg = dataclasses.replace(ref_get_arch(arch, smoke=True),
                                  dtype="float64")
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="float64")
    with jax.enable_x64(True):
        ref_params = jax.tree.map(np.asarray, ref_tf.init_params(
            ref_cfg, jax.random.PRNGKey(3)))
    params = transformer_params_from_reference(ref_params, cfg,
                                               device="cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module", params=["gemma2-9b", "mistral-nemo-12b",
                                        "qwen1.5-32b"])
def dense(request):
    """(cfg, port params, batch, the reference's loss and gradients);
    qwen's QKV biases drawn away from their zero init."""
    ref_cfg, cfg, ref_params, params = _setup(request.param)
    if ref_cfg.qkv_bias:
        r = np.random.default_rng(8)
        layers = dict(ref_params["layers"])
        for b in ("bq", "bk", "bv"):
            layers[b] = 0.1 * r.standard_normal(layers[b].shape)
        ref_params = dict(ref_params, layers=layers)
        params = transformer_params_from_reference(ref_params, cfg,
                                                   device="cpu")
    batch = _batch(cfg)
    with reference_in_float64(ref_tf, ref_ops):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_tf.lm_loss(p, b, ref_cfg,
                                        loss_chunks=CHUNKS)))(
            jax.tree.map(jnp.asarray, ref_params),
            jax.tree.map(jnp.asarray, batch))
        want = (float(loss), jax.tree.map(np.asarray, grads))
    return cfg, params, batch, want


def _loss_and_grads(params, batch, cfg):
    p = adamw.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = tf.lm_loss(p, {k: torch.from_numpy(v) for k, v in batch.items()},
                      cfg, loss_chunks=CHUNKS)
    loss.backward()
    return loss.detach(), adamw.tree_map(lambda t: t.grad, p)


def test_lm_loss_and_gradients_match_reference(dense):
    cfg, params, batch, (want_loss, want_grads) = dense
    loss, grads = _loss_and_grads(params, batch, cfg)
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    got = adamw.tree_leaves(grads)
    ref = adamw.tree_leaves(want_grads)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert np.abs(g.numpy() - r).max() <= TOL * np.abs(r).max()


def test_remat_on_and_off_are_equal(dense):
    cfg, params, batch, _ = dense
    runs = [_loss_and_grads(params, batch, dataclasses.replace(cfg, remat=r))
            for r in ("none", "full")]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(*(adamw.tree_leaves(g) for _, g in runs)):
        assert torch.equal(a, b)


def test_moe_loss_matches_reference():
    """moonshot's smoke config: the cross-entropy plus ``router_aux_loss``
    times the layers' mean aux loss (no autograd here, so the attention is
    named: ``"blocked"``, the reference's train path, in float64; the
    no-grad default is ``attention_ref``, float32 as the reference's
    ``ref``)."""
    ref_cfg, cfg, ref_params, params = _setup("moonshot-v1-16b-a3b")
    batch = _batch(cfg, seed=4)
    with reference_in_float64(ref_tf, ref_ops):
        want = float(jax.jit(lambda p, b: ref_tf.lm_loss(
            p, b, ref_cfg, loss_chunks=CHUNKS))(
            jax.tree.map(jnp.asarray, ref_params),
            jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = tf.lm_loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg,
                         attn_impl="blocked", loss_chunks=CHUNKS)
    assert abs(float(got) - want) <= TOL * abs(want)
    _, aux = tf.forward_hidden(params, torch.from_numpy(batch["tokens"]),
                               cfg)
    assert float(aux) > 0       # the aux term is in the loss


def test_three_adamw_steps_on_a_bf16_tree_match_reference():
    r = np.random.default_rng(5)
    shapes = {"a": (40, 24), "b": (7,), "c": (3, 5, 8)}
    p0 = {k: r.standard_normal(s).astype(np.float32) for k, s in
          shapes.items()}
    kw = dict(lr=0.05, warmup=2, weight_decay=0.1, clip_norm=1.0)
    grads = [{k: (r.standard_normal(s) * 1e-2).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    p = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    opt = ref_adamw.init_state(p)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    topt = adamw.init_state(tp)
    for g in grads:
        p, opt, stats = ref_adamw.apply_updates(
            p, opt, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
            RefTrainConfig(**kw))
        tp, topt, _ = adamw.apply_updates(
            tp, topt, {k: torch.from_numpy(v).to(torch.bfloat16)
                       for k, v in g.items()}, TrainConfig(**kw))
        for k in shapes:
            want = np.asarray(p[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            assert tp[k].dtype == torch.bfloat16
            assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
            for mine, theirs in ((topt.m, opt.m), (topt.v, opt.v)):
                ref = np.asarray(theirs[k])
                assert np.abs(mine[k].numpy() - ref).max() <= \
                    REL * np.abs(ref).max()
        assert int(topt.step) == int(opt.step)
        assert float(stats["grad_norm"]) < kw["clip_norm"]


def test_ef_compress_grads_is_bit_equal_to_reference():
    r = np.random.default_rng(6)
    grads = {"w": r.standard_normal((30, 17)).astype(np.float32) * 3,
             "layers": {"b": r.standard_normal(11).astype(np.float32)}}
    resid = {"w": r.standard_normal((30, 17)).astype(np.float32) * 1e-2,
             "layers": {"b": np.zeros(11, np.float32)}}
    q, s, nr = ref_comp.ef_compress_grads(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, resid))
    tg = adamw.tree_map(torch.from_numpy, grads)
    tq, ts, tnr = compression.ef_compress_grads(
        tg, adamw.tree_map(torch.from_numpy, resid))
    for mine, theirs in ((tq, q), (ts, s), (tnr, nr)):
        for a, b in zip(adamw.tree_leaves(mine), jax.tree.leaves(theirs)):
            assert np.array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype
    zeros = compression.init_residual(tg)
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in adamw.tree_leaves(zeros))
    deq = compression.dequantize_int8(tq["w"], ts["w"])
    assert torch.equal(deq + tnr["w"], tg["w"] + torch.from_numpy(
        resid["w"]))


def test_train_cell_step_is_lm_loss_then_adamw():
    """The cell's step at cut batch and length: its loss is ``lm_loss`` of
    the batch and its update ``apply_updates`` of that gradient."""
    cell = build_cell("gemma2-9b", "train_4k", smoke=True, device="cpu",
                      batch=B, seq_len=S)
    assert cell.note == "batch 2 of 256; seq_len 32 of 4096"
    params, opt = cell.init(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cell.cfg).items()}
    twin = adamw.tree_map(lambda t: t.clone(), params)
    p = adamw.tree_map(lambda t: t.clone().requires_grad_(), twin)
    loss = tf.lm_loss(p, batch, cell.cfg)
    loss.backward()
    want, _, _ = adamw.apply_updates(
        twin, adamw.init_state(twin), adamw.tree_map(lambda t: t.grad, p),
        cell.train_cfg)
    params, opt, got_loss, stats = cell.step_fn(params, opt,
                                                cell.inputs(_batch(cell.cfg)))
    assert torch.equal(got_loss, loss.detach()) and int(opt.step) == 1
    assert all(torch.equal(a, b) and not a.requires_grad for a, b in
               zip(adamw.tree_leaves(params), adamw.tree_leaves(want)))


def test_train_launcher_resumes_equal_to_an_uninterrupted_run(tmp_path,
                                                              capsys):
    base = ["--arch", "gemma2-9b", "--smoke", "--device", "cpu", "--steps",
            "4", "--seq-len", str(S), "--batch", str(B), "--ckpt-every", "2",
            "--log-every", "2"]

    def run(argv):
        code = train_launcher.main(base + argv)
        return code, json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])

    code, whole = run(["--ckpt-dir", str(tmp_path / "a")])
    assert code == 0 and whole["saved"] == [2, 4]
    assert whole["losses"][-1] < whole["losses"][0] + 1.0
    code, first = run(["--ckpt-dir", str(tmp_path / "b"),
                       "--preempt-after", "2"])
    assert code == 75 and first["preempted"] and first["saved"] == [2]
    assert latest_step(str(tmp_path / "b")) == 2
    code, rest = run(["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert code == 0 and rest["resumed_from"] == 2
    assert rest["cursor"] == {"step": 4, "shard": 0}
    assert first["losses"] + rest["losses"] == whole["losses"]
    for f in sorted((tmp_path / "a" / "step_00000004").glob("*.npy")):
        assert f.read_bytes() == (tmp_path / "b" / "step_00000004"
                                  / f.name).read_bytes()
    code, ef = run(["--ckpt-dir", str(tmp_path / "c"), "--steps", "2",
                    "--grad-compression", "int8_ef"])
    assert code == 0 and all(np.isfinite(ef["losses"]))
    with pytest.raises(SystemExit):
        train_launcher.parse_args(["--mesh", "2x1"])
