"""The cases the flash attention kernel is held to its plain version on, the
bf16 rule it is held by, and a planted fault that the rule must reject.

One table serves the CPU tests (the plain version against the reference's),
the card tests and ``chip_smoke.py`` (the kernel against the plain version),
so that the three cannot drift apart.

The bf16 rule is element by element: ``|o - r| <= 2^-7 |r| + 2^-8 rowmax|r|``,
where ``rowmax|r|`` is the largest ``|r|`` of the element's output row.
``2^-7 |r|`` is one bf16 ulp of the element: each side rounds its float32
result to bf16 on its own. ``2^-8 rowmax|r|`` covers what scales with the
row rather than the element: the kernel rounds P to bf16 before the P V
product, and an element near zero has no ulp of its own to speak of. A row
of the plain version that is all zero (no valid key) must come out exactly
zero. A global tolerance (a multiple of the whole tensor's largest value)
would not do: on a long row the outputs average thousands of keys and are
small, so such a tolerance can exceed them and pass a kernel that drops
keys. ``planted_fault`` makes such a kernel's output, so that a run can show
that the rule rejects it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

# name -> (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, kv_len, q_offset,
#          q_scale); kv_len may be a per-batch-row list. q_scale multiplies q
#          (large scores make the softcap bite).
CASES = {
    "gqa1-causal": (2, 4, 4, 40, 40, 16, True, 0, 0.0, None, None, 1.0),
    "gqa2-causal": (2, 4, 2, 100, 100, 64, True, 0, 0.0, None, None, 1.0),
    "gqa2-bidirectional": (1, 4, 2, 33, 50, 128, False, 0, 0.0, None, None,
                           1.0),
    "window16": (1, 4, 2, 130, 130, 256, True, 16, 0.0, None, None, 1.0),
    "softcap50": (1, 2, 1, 48, 48, 64, True, 0, 50.0, None, None, 30.0),
    "window16-softcap50": (2, 4, 2, 145, 145, 64, True, 16, 50.0, None,
                           None, 30.0),
    "kv_len-chunk": (2, 4, 2, 24, 64, 128, True, 0, 0.0, 40, 16, 1.0),
    "kv_len-per-row": (3, 4, 2, 12, 48, 64, True, 8, 50.0, [42, 31, 0], 30,
                       30.0),
    "q_offset-window-softcap": (1, 4, 2, 8, 64, 256, True, 16, 50.0, 48, 40,
                                30.0),
    "ragged": (1, 4, 2, 37, 53, 16, True, 16, 0.0, None, None, 1.0),
    "decode-row": (4, 16, 8, 1, 700, 256, True, 512, 50.0, 700, 699, 30.0),
    # rows at 60.. see keys (60 - 4, 60] only, and kv_len 40 hides them all
    "fully-masked-rows": (1, 4, 2, 8, 64, 64, True, 4, 0.0, 40, 60, 1.0),
    "no-valid-key": (2, 2, 1, 16, 32, 128, False, 0, 0.0, 0, None, 1.0),
    # gemma2-9b's heads, head dim, softcap and layer kinds at S = 1000
    "gemma2-global-S1000": (2, 16, 8, 1000, 1000, 256, True, 0, 50.0, None,
                            None, 1.0),
    "gemma2-local-S1000-w300": (2, 16, 8, 1000, 1000, 256, True, 300, 50.0,
                                None, None, 1.0),
}

BF16_ELEMENT_ULPS = 2.0 ** -7   # of the element's own |r|
BF16_ROW_SHARE = 2.0 ** -8      # of the row's largest |r|


def case_kwargs(case, device=None) -> dict:
    """The attention keyword arguments of a case; a per-row ``kv_len`` list
    becomes an int32 tensor on ``device``."""
    _, _, _, _, _, _, causal, window, softcap, kv_len, q_offset, _ = case
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
                q_offset=q_offset)


def bf16_excess(out: torch.Tensor, ref: torch.Tensor,
                chunk: int = 1024) -> float:
    """The largest ``|out - ref|`` over its allowance under the bf16 rule
    (module docstring); the kernel passes when this is at most 1. An element
    whose allowance is 0 (a zero row) counts as 0 if it equals ``ref``
    exactly and as infinity if not. Works over the query axis in chunks, so
    no full-size float32 copies are made."""
    worst = 0.0
    for i in range(0, ref.shape[-2], chunk):
        r = ref[..., i:i + chunk, :].float()
        err = (out[..., i:i + chunk, :].float() - r).abs()
        allow = (BF16_ELEMENT_ULPS * r.abs()
                 + BF16_ROW_SHARE * r.abs().amax(dim=-1, keepdim=True))
        ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
        worst = max(worst, float(ratio.max()))
    return worst


def planted_fault(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  from_row: int, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None,
                  tile: int = 64) -> torch.Tensor:
    """Causal attention as a kernel with an off-by-one in its kv loop's start
    would compute it: each ``tile``-row query tile at or past ``from_row``
    skips the first key tile it would visit (on a windowed layer, the tile
    the window's edge cuts). Every other row is the plain version's."""
    out = attention_ref(q, k, v, causal=True, window=window, softcap=softcap,
                        scale=scale)
    for q0 in range(from_row - from_row % tile, q.shape[2], tile):
        first = max(0, q0 - window + 1) // tile * tile if window > 0 else 0
        start = first + tile
        out[:, :, q0:q0 + tile] = attention_ref(
            q[:, :, q0:q0 + tile], k[:, :, start:], v[:, :, start:],
            causal=True, window=window, softcap=softcap, scale=scale,
            q_offset=q0 - start)
    return out
