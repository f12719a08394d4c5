"""Device-gated while loop with one host read per chunk of supersteps.

The JAX reference runs its superstep loops (``growth_loop``, ``_bf_loop``,
``batched_bf_loop``) inside ``lax.while_loop`` with no host read. In eager
PyTorch a Python loop whose condition is a device value syncs on every
iteration. Here the condition is evaluated ON THE DEVICE before each
superstep and gates the update, so a superstep issued after the loop has
logically stopped is a no-op; the host reads one packed stats vector per
``chunk`` supersteps (through ``guard.fetch``) to decide whether to issue
another chunk. The result is byte-identical to the unchunked loop; the
cost is up to ``chunk - 1`` idle supersteps after the stop, and one host
read per chunk.
"""
from __future__ import annotations

from typing import Callable, List, Tuple, TypeVar

import numpy as np
import torch

from repro_torch import guard

Carry = TypeVar("Carry")

DEFAULT_CHUNK = 8


def chunked_while(
    cond: Callable[[Carry], torch.Tensor],
    body: Callable[[Carry, torch.Tensor], Carry],
    carry: Carry,
    *,
    chunk: int,
    stats: Callable[[Carry], List[torch.Tensor]],
    reason: str,
) -> Tuple[Carry, np.ndarray, int]:
    """Run ``while cond(carry): carry = body(carry)`` without a host read per
    iteration.

    ``body(carry, more)`` must leave ``carry`` unchanged when the 0-dim bool
    tensor ``more`` is False. ``stats(carry)`` lists 0-dim integer tensors
    that are read with the stop flag. Returns ``(carry, host_stats, reads)``
    where ``host_stats[0]`` is the final (False) flag and
    ``host_stats[1:]`` the stats at exit.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    reads = 0
    while True:
        for _ in range(chunk):
            carry = body(carry, cond(carry))
        packed = torch.stack([cond(carry).to(torch.int64)]
                             + [s.to(torch.int64) for s in stats(carry)])
        host = guard.fetch(packed, reason=reason)
        reads += 1
        if not host[0]:
            return carry, host, reads
