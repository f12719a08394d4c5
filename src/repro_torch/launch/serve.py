"""Batched LM serving driver: prefill and steady-state decode with a KV
cache, the port of the JAX package's ``launch/serve.py --mode lm``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --batch 4 --prompt-len 32 --gen 16 [--smoke] [--temperature 0.7] \
      [--device cuda]

As in the reference, the weights are randomly initialised (seed 0) and the
prompt is streamed through ``decode_step`` one position at a time, so the
prefill and the decode run the same step. Sampling is greedy, or draws
from ``softmax(logits / temperature)`` with an explicit ``torch.Generator``.
Prints the prefill and decode rates, ``ids[0, :8]``, and one JSON line of
the run's numbers. ``--mode graph-diameter`` (the session pool and update
traces) is a later slice of the port and is rejected.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import torch

from repro_torch.common import Timer, get_logger, resolve_device
from repro_torch.config.registry import get_arch
from repro_torch.models import transformer as tf_mod

log = get_logger("repro_torch.serve")

SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", default="lm")
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode != "lm":
        ap.error(f"--mode {args.mode!r} is not ported yet: the port serves "
                 f"--mode lm only (graph-diameter serving is a later slice)")
    for name in ("batch", "prompt_len", "gen"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if args.temperature < 0:
        ap.error("--temperature must be >= 0")
    return args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(args: argparse.Namespace) -> Dict[str, Any]:
    """Initialise the model, stream the prompts through ``decode_step``,
    decode ``args.gen`` tokens per request; returns the run's numbers and
    the generated ids (int64 ``[batch, gen]``, on the host)."""
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    with Timer() as t_init:
        params = tf_mod.init_params(cfg, seed=SEED, device=dev)
        _sync(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    cache = tf_mod.init_cache(cfg, args.batch, args.prompt_len + args.gen,
                              device=dev)

    def step(tokens):
        return tf_mod.decode_step(params, cache, tokens, cfg)

    # prefill by streaming the prompt through decode (one step function, as
    # the reference; a batched prefill is prefill_step)
    with Timer() as t_prefill:
        logits = None
        for i in range(args.prompt_len):
            logits, cache = step(prompts[:, i:i + 1])
        _sync(dev)

    toks = []
    with Timer() as t_decode:
        cur = torch.argmax(logits, -1)[:, None]
        for _ in range(args.gen):
            toks.append(cur)
            logits, cache = step(cur)
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=gen)
            else:
                cur = torch.argmax(logits, -1)[:, None]
        _sync(dev)

    ids = torch.cat(toks, dim=1).cpu()   # one read of all decoded ids
    res = {
        "arch": cfg.name, "params": cfg.param_count(), "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "device": str(dev), "init_seconds": t_init.seconds,
        "prefill_seconds": t_prefill.seconds,
        "prefill_tok_s": args.batch * args.prompt_len / t_prefill.seconds,
        "decode_seconds": t_decode.seconds,
        "decode_tok_s": args.batch * args.gen / t_decode.seconds,
        "decode_tok_s_per_seq": args.gen / t_decode.seconds,
        "decode_ms_per_step": 1e3 * t_decode.seconds / args.gen,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "ids": ids,
    }
    return res


def main(argv=None) -> int:
    args = parse_args(argv)
    res = serve_lm(args)
    ids = res.pop("ids")
    log.info("prefill %.2fs (%.1f tok/s)  decode %.2fs (%.1f tok/s/seq)",
             res["prefill_seconds"], res["prefill_tok_s"],
             res["decode_seconds"], res["decode_tok_s_per_seq"])
    log.info("generated ids[0,:8] = %s", ids[0, :8].tolist())
    print(json.dumps({**res, "ids0": ids[0, :8].tolist()}))
    return 0 if res["logits_finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
