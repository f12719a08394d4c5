"""LM training launcher, the port of the JAX package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \
      --smoke --steps 50 [--resume] [--grad-compression int8_ef] \
      [--device cuda]

Trains an LM arch, dense or MoE (``launch/steps.lm_train_step``:
``lm_loss``, autograd with the flash attention backward kernel on the
card and, for an MoE arch, through the capacity dispatch in one group,
AdamW in place) on ``LMTokenPipeline`` batches, with the reference's
production semantics on one device:
  * checkpoints of ``params``, ``m`` and ``v`` with ``extra = {cursor,
    opt_step}`` every ``--ckpt-every`` steps (``checkpoint.save``; bf16
    leaves written as the reference writes them), and ``--resume`` from
    the newest one, replaying the data stream from its cursor;
  * a ``PreemptionGuard``: SIGTERM or SIGINT checkpoints after the step
    in flight and exits with ``EXIT_PREEMPTED`` (75);
  * a ``StragglerMonitor`` over the step times (host clock, ending in a
    synchronize on the card);
  * ``--grad-compression int8_ef``: each step's gradients go through
    ``runtime/compression.ef_compress_grads`` (int8 with error feedback)
    and back to float32 before the update.
The weights are drawn from a generator seeded with ``TrainConfig.seed``
(the reference draws from ``jax.random``, so the values differ).
``--mesh`` other than ``1x1`` is refused: the port runs on one card.
``--preempt-after K`` (a test hook) sends the process a real SIGTERM
after step K.

Prints a log line every ``--log-every`` steps and, at the end, one JSON
line: the steps run, every step's loss (read once, at the end), the
median step seconds and tokens/s, the steps saved, whether the run was
preempted, the flagged stragglers.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.common import Timer, get_logger, resolve_device
from repro_torch.config.base import ShapeSpec, TrainConfig, TransformerConfig
from repro_torch.config.registry import get_arch
from repro_torch.data.pipeline import DataCursor, LMTokenPipeline
from repro_torch.launch.steps import lm_train_step
from repro_torch.models import transformer as tf_mod
from repro_torch.optim import adamw
from repro_torch.runtime.compression import (dequantize_int8,
                                             ef_compress_grads,
                                             init_residual)
from repro_torch.runtime.fault import (EXIT_PREEMPTED, PreemptionGuard,
                                       StragglerMonitor)

log = get_logger("repro_torch.train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM; the port runs on one card: 1x1 only")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="test hook: SIGTERM this process after step K")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port trains on one card; only "
                 f"1x1 is supported")
    return args


def _ef_transform(residual: dict):
    """The int8 error-feedback round trip of a gradient tree, carrying the
    residual from step to step in ``residual["r"]``."""
    def transform(grads):
        q, s, residual["r"] = ef_compress_grads(grads, residual["r"])
        return adamw.tree_map(dequantize_int8, q, s)
    return transform


def train(args: argparse.Namespace) -> dict:
    """The training run of ``args``; returns the JSON line's fields (and
    ``exit``, the launcher's exit code)."""
    cfg = get_arch(args.arch, smoke=args.smoke)
    if not isinstance(cfg, TransformerConfig):
        raise ValueError(f"{args.arch}: train.py drives LM archs")
    dev = resolve_device(args.device)
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every,
                     grad_compression=args.grad_compression,
                     log_every=args.log_every)
    shape = ShapeSpec(name="cli", kind="train", seq_len=args.seq_len,
                      global_batch=args.batch)
    step_fn = lm_train_step(cfg, tc, total_steps=args.steps)
    params = tf_mod.init_params(cfg, seed=tc.seed, device=dev)
    opt = adamw.init_state(params)
    transform = (_ef_transform({"r": init_residual(params)})
                 if args.grad_compression == "int8_ef" else None)
    pipe = LMTokenPipeline(cfg, shape, seed=tc.seed)
    cursor = DataCursor()
    resumed_from = None
    if args.resume and ckpt.latest_step(tc.checkpoint_dir) is not None:
        like = {"params": params, "m": opt.m, "v": opt.v}
        restored, extra = ckpt.restore(tc.checkpoint_dir, like)
        del like
        params = restored["params"]
        opt = adamw.AdamWState(m=restored["m"], v=restored["v"],
                               step=torch.full((), int(extra.get(
                                   "opt_step", 0)), dtype=torch.int32,
                                   device=dev))
        cursor = DataCursor.from_dict(extra.get("cursor", {}))
        resumed_from = cursor.step
        log.info("resumed at data step %d (opt step %d)", cursor.step,
                 int(extra.get("opt_step", 0)))

    mon = StragglerMonitor()
    losses, secs, saved = [], [], []
    first = cursor.step
    preempted = False
    with PreemptionGuard() as guard:
        while cursor.step < args.steps:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(cursor).items()}
            with Timer() as t:
                params, opt, loss, stats = step_fn(params, opt, batch,
                                                   grad_transform=transform)
                if dev.type == "cuda":
                    # sync: the step's host clock ends when the card is done
                    torch.cuda.synchronize(dev)
            mon.record(cursor.step, t.seconds)
            secs.append(t.seconds)
            losses.append(loss)
            cursor.step += 1
            if args.preempt_after and cursor.step == args.preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            if cursor.step % args.log_every == 0:
                # a host read, gated by --log-every
                log.info("step %d loss %.4f gnorm %.3f lr %.2e  %.0f tok/s",
                         cursor.step, float(loss), float(stats["grad_norm"]),
                         float(stats["lr"]),
                         args.batch * args.seq_len / max(t.seconds, 1e-9))
            if cursor.step % tc.checkpoint_every == 0 or guard.should_stop:
                ckpt.save(tc.checkpoint_dir, cursor.step,
                          {"params": params, "m": opt.m, "v": opt.v},
                          extra={"cursor": cursor.as_dict(),
                                 "opt_step": int(opt.step)},
                          keep=tc.keep_checkpoints)
                saved.append(cursor.step)
            if guard.should_stop:
                log.warning("preempted: checkpointed at step %d, exiting",
                            cursor.step)
                preempted = True
                break
    med = float(np.median(secs)) if secs else 0.0
    return {"arch": cfg.name, "device": str(dev), "first_step": first,
            "steps_run": len(secs), "cursor": cursor.as_dict(),
            "resumed_from": resumed_from,
            "losses": [float(x) for x in losses],
            "step_seconds_median": med,
            "tok_s": args.batch * args.seq_len / med if med else 0.0,
            "saved": saved, "preempted": preempted,
            "stragglers": mon.flagged,
            "params": sum(p.numel() for p in adamw.tree_leaves(params)),
            "exit": EXIT_PREEMPTED if preempted else 0}


def main(argv=None) -> int:
    res = train(parse_args(argv))
    print(json.dumps(res), flush=True)
    return res["exit"]


if __name__ == "__main__":
    raise SystemExit(main())
