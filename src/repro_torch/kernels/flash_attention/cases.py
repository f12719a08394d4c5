"""The cases the flash attention kernels are held to their plain versions
on, the bf16 rules they are held by, and planted faults that the rules
must reject: the forward's (``CASES``, ``bf16_excess``, ``planted_fault``)
and the backward's (``GRAD_CASES``, ``grad_reference``, ``grad_excess``,
``GRAD_FAULTS``; see "The backward" below).

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

The backward. dq, dk and dv are held element by element to the float64
evaluation of the same formulas (``grad_reference``: ``P = exp(S - lse)``,
``dS = P (dP - delta) cf``, ``cf = 1 - (s/cap)^2``) on the kernel's own
bf16 inputs and float32 ``lse``: ``|g - r| <= 2^-7 |r| + A``. ``2^-7 |r|``
is one bf16 ulp of the element (each side rounds on its own). ``A`` bounds
what the sum's terms may err by, taken on absolute values term by term:
  * P and dS are rounded to bf16 before the products (``2^-8`` of each);
  * P errs relatively by the float32 error of its score, ``D 2^-24
    |cf| sum|q||k| scale`` (a worst-case float32 dot product), plus
    ``2^-16`` for the fast exponential, divide and lse;
  * ``dP - delta`` is a difference of two float32 sums over D that cancel
    where a row's mass sits on one key (a row with one key has dS = 0
    exactly): ``D 2^-24 (sum|dO||V| + sum|dO||O|)``;
  * with a softcap, ``cf`` errs absolutely by ``2^-20`` (float32 tanh).
So ``A = sum_q P (2^-8 + e_P) |dO|`` for dv, and ``sum E_dS |q| scale``
(dk) or ``sum E_dS |k| scale`` (dq) with ``E_dS = (2^-8 + e_P) |dS| +
P |cf| D 2^-24 (sum|dO||V| + sum|dO||O|) + 2^-20 P |dP - delta|``. Every
other rounding (the float32 products' sums) is far below these. Read as
"excess" (pass at <= 1); an element of allowance 0 (a key no query sees,
a fully masked row) must be exactly 0. A kernel that skips one tile must
read above 1: ``GRAD_FAULTS`` are the two faults the two launches can
make, an off-by-one in a loop's start that drops the first query tile a
key tile's block visits (dK and dV) or the first kv tile a query tile's
block visits (dQ). ``bwd_loops`` gives those loops as the kernels run
them (``kernel.BWD_BLOCK_ROWS`` and ``BWD_STAGE_ROWS``), and
``emulated_backward`` the kernels' arithmetic in their tile order: P and
dS in float32, rounded to bf16 where they become an operand, float32
sums.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (BWD_BLOCK_ROWS,
                                                       BWD_STAGE_ROWS,
                                                       KV_TILE, Q_TILE)
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
    # the tensor-core kernel's tile edges (128 query rows per block, 64 keys
    # per kv tile, a ring of 2 stages): a second block of 1 row and of 72
    # rows, Skv past the last full kv tile
    "sq129-skv193-offset64": (1, 4, 2, 129, 193, 64, True, 0, 0.0, None, 64,
                              1.0),
    "sq200-skv300-bidirectional": (2, 4, 2, 200, 300, 128, False, 0, 0.0,
                                   None, None, 1.0),
    # a window of 100 keys cuts two kv tiles on every row
    "d256-gqa2-window100": (1, 4, 2, 300, 300, 256, True, 100, 50.0, None,
                            None, 1.0),
    # kv_len 250 ends inside kv tile 3 (keys 192-255), the ring's last stage
    "kv_len-in-last-stage": (2, 4, 2, 64, 256, 128, True, 0, 0.0, 250, 190,
                             1.0),
    "d32-gqa4": (2, 8, 2, 150, 150, 32, True, 0, 0.0, None, None, 1.0),
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
        # sync: a check's verdict, read once per comparison (tests, chip_smoke)
        worst = max(worst, float(ratio.max()))
    return worst


def planted_fault(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  from_row: int, window: int = 0, softcap: float = 0.0,
                  scale: Optional[float] = None, q_tile: int = Q_TILE,
                  kv_tile: int = KV_TILE) -> torch.Tensor:
    """Causal attention as a kernel with an off-by-one in its kv loop's start
    would compute it: each ``q_tile``-row query tile at or past ``from_row``
    skips the first ``kv_tile``-key tile it would visit (on a windowed
    layer, the tile the window's edge cuts). Every other row is the plain
    version's. The defaults are the tensor-core kernel's tiles, so the
    dropped tile is one the kernel visits."""
    out = attention_ref(q, k, v, causal=True, window=window, softcap=softcap,
                        scale=scale)
    for q0 in range(from_row - from_row % q_tile, q.shape[2], q_tile):
        first = (max(0, q0 - window + 1) // kv_tile * kv_tile if window > 0
                 else 0)
        start = first + kv_tile
        out[:, :, q0:q0 + q_tile] = attention_ref(
            q[:, :, q0:q0 + q_tile], k[:, :, start:], v[:, :, start:],
            causal=True, window=window, softcap=softcap, scale=scale,
            q_offset=q0 - start)
    return out


# the backward's cases (same fields as CASES): GQA 1, 2 and 4; causal and
# bidirectional; windows; softcap 50 (q scaled by 30 so that it bites);
# both; q_offset; kv_len per row (one row empty); ragged Sq and Skv past
# the 64-row tiles; rows with no valid key; head dims 128 and 256
GRAD_CASES = {
    "gqa1-causal-d128": (2, 4, 4, 96, 96, 128, True, 0, 0.0, None, None,
                         1.0),
    "gqa2-causal-d256": (1, 4, 2, 130, 130, 256, True, 0, 0.0, None, None,
                         1.0),
    "gqa4-bidirectional-d128": (1, 8, 2, 77, 150, 128, False, 0, 0.0, None,
                                None, 1.0),
    "window40-d256": (1, 4, 2, 200, 200, 256, True, 40, 0.0, None, None,
                      1.0),
    "softcap50-d256": (1, 4, 2, 100, 100, 256, True, 0, 50.0, None, None,
                       30.0),
    "window40-softcap50-d128": (2, 4, 2, 160, 160, 128, True, 40, 50.0,
                                None, None, 30.0),
    "q_offset-d128": (1, 4, 2, 70, 200, 128, True, 0, 0.0, None, 130, 1.0),
    "kv_len-per-row-d256": (3, 4, 2, 64, 150, 256, True, 0, 50.0,
                            [150, 97, 0], 86, 30.0),
    "ragged-bidirectional-d128": (2, 4, 2, 129, 193, 128, False, 0, 0.0,
                                  None, None, 1.0),
    # rows at 73 .. 101 see keys (qpos - 4, qpos], all at or past kv_len 70
    "fully-masked-rows-d128": (1, 4, 2, 72, 130, 128, True, 4, 0.0, 70, 30,
                               1.0),
    # gemma2-9b's heads, head dim and softcap on a local layer
    "gemma2-local-S300-w100": (1, 16, 8, 300, 300, 256, True, 100, 50.0,
                               None, None, 1.0),
}

GRAD_FAULTS = ("dkdv", "dq")


def pair_mask(B: int, Sq: int, Skv: int, kv_len=None, q_offset=None,
              causal: bool = True, window: int = 0,
              device=None) -> torch.Tensor:
    """bool ``[B', Sq, Skv]`` (B' 1 or B): the unmasked (query, key)
    pairs."""
    off = 0 if q_offset is None else q_offset
    q_pos = torch.arange(Sq, device=device).reshape(Sq, 1) + torch.as_tensor(
        off, device=device).reshape(-1)[0]
    k_pos = torch.arange(Skv, device=device)
    kvl = torch.as_tensor(Skv if kv_len is None else kv_len,
                          device=device).reshape(-1, 1, 1)
    m = (k_pos < kvl) & torch.ones((Sq, Skv), dtype=torch.bool,
                                   device=device)
    if causal:
        m = m & (q_pos >= k_pos)
    if window > 0:
        m = m & ((q_pos - k_pos) < window)
    return m


def bwd_loops(Sq: int, Skv: int, head_dim: int, kv_len: int,
              q_offset: int = 0, causal: bool = True, window: int = 0,
              group: int = 1) -> dict:
    """The backward kernels' loops for one batch row (``kv_len`` its valid
    keys), as ``csrc/flash_attention.cu`` runs them at ``head_dim``:
    ``dkdv``, per block, ``(k0, [(g, q0), ...])``: its first key and the
    (query head in the group, 64-row query tile) of each iteration, in
    order; ``dq``, per block, ``(q0, [k0, ...])``: its first query row and
    the 64-key tiles it walks. Blocks span ``BWD_BLOCK_ROWS[head_dim]``
    keys (dK/dV) or query rows (dQ)."""
    outer, r = BWD_BLOCK_ROWS[head_dim], BWD_STAGE_ROWS
    off = q_offset or 0
    dkdv = []
    for k0 in range(0, Skv, outer):
        its = []
        if k0 < kv_len:
            k_last = min(k0 + outer, kv_len) - 1
            i_lo = max(0, k0 - off) if causal else 0
            i_hi = min(Sq, k_last + window - off) if window > 0 else Sq
            start = i_lo // r * r
            its = [(g, q0) for g in range(group)
                   for q0 in range(start, i_hi, r)]
        dkdv.append((k0, its))
    dq = []
    for q0 in range(0, Sq, outer):
        q_last = off + min(q0 + outer, Sq) - 1
        k_hi = min(kv_len, q_last + 1) if causal else kv_len
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        dq.append((q0, list(range(k_lo // r * r, k_hi, r))))
    return {"dkdv": dkdv, "dq": dq}


def _row_kv_lens(B: int, Skv: int, kv_len) -> list:
    kvl = torch.as_tensor(Skv if kv_len is None else kv_len).reshape(-1)
    # sync: a test case's kv_len rows, given on the host
    return [min(max(int(kvl[b if kvl.numel() > 1 else 0]), 0), Skv)
            for b in range(B)]


def dropped_pairs(mask: torch.Tensor, fault: str, head_dim: int,
                  kv_len=None, q_offset=None, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """The pairs a kernel with the planted ``fault`` leaves out, by
    ``bwd_loops``: for ``"dkdv"``, per key block, the unmasked pairs of the
    first query tile it visits; for ``"dq"``, per query block, those of the
    first kv tile it visits."""
    Bp, Sq, Skv = mask.shape
    outer, r = BWD_BLOCK_ROWS[head_dim], BWD_STAGE_ROWS
    drop = torch.zeros_like(mask)
    for b, kvl in enumerate(_row_kv_lens(Bp, Skv, kv_len)):
        loops = bwd_loops(Sq, Skv, head_dim, kvl, q_offset, causal, window)
        if fault == "dkdv":
            for k0, its in loops["dkdv"]:
                if its:
                    q0 = its[0][1]
                    drop[b, q0:q0 + r, k0:k0 + outer] = True
        else:
            for q0, kts in loops["dq"]:
                if kts:
                    drop[b, q0:q0 + outer, kts[0]:kts[0] + r] = True
    return drop & mask


def grad_reference(q, k, v, o, lse, do, *, kv_len=None, q_offset=None,
                   causal: bool = True, window: int = 0,
                   softcap: float = 0.0, scale: Optional[float] = None,
                   drop: Optional[str] = None, chunk: int = 512,
                   dtype=torch.float64, tiles_of: Optional[int] = None
                   ) -> dict:
    """The backward in ``dtype`` on these inputs (lse as given): ``dq``,
    ``dk``, ``dv`` and the rule's term bounds ``a_dq``, ``a_dk``, ``a_dv``
    (module docstring), over the query rows in chunks of ``chunk``. With
    ``drop`` (one of ``GRAD_FAULTS``) the gradients leave out the pairs of
    ``dropped_pairs`` instead (the planted fault's output), in the kernels'
    tiles at head dim ``tiles_of`` (default: q's)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = float(scale if scale is not None else D ** -0.5)
    dev = q.device
    mask = pair_mask(B, Sq, Skv, kv_len, q_offset, causal, window, dev)
    gone = (dropped_pairs(mask, drop, tiles_of or D, kv_len, q_offset,
                          causal, window) if drop else None)
    kd = k.to(dtype).repeat_interleave(G, dim=1)
    vd = v.to(dtype).repeat_interleave(G, dim=1)
    out = {n: torch.zeros((B, Hq, Skv, D), dtype=dtype, device=dev)
           for n in ("dk", "dv", "a_dk", "a_dv")}
    out["dq"] = torch.zeros((B, Hq, Sq, D), dtype=dtype, device=dev)
    out["a_dq"] = torch.zeros_like(out["dq"])
    for i in range(0, Sq, chunk):
        rows = slice(i, i + chunk)
        qc, oc, dc = (t[:, :, rows].to(dtype) for t in (q, o, do))
        s = torch.einsum("bhqd,bhkd->bhqk", qc * scale, kd)
        cf = torch.ones((), dtype=dtype, device=dev)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
            cf = 1.0 - (s / softcap) ** 2
        m = mask[:, None, rows]
        p = torch.where(m, torch.exp(s - lse[:, :, rows, None].to(dtype)),
                        0.0)
        delta = (dc * oc).sum(-1, keepdim=True)
        dpd = torch.einsum("bhqd,bhkd->bhqk", dc, vd) - delta
        ds = p * dpd * cf
        keep_kv = keep_q = None
        if drop == "dkdv":
            keep_kv = ~gone[:, None, rows]
        elif drop == "dq":
            keep_q = ~gone[:, None, rows]
        pk = p if keep_kv is None else p * keep_kv
        dsk = ds if keep_kv is None else ds * keep_kv
        dsq = ds if keep_q is None else ds * keep_q
        out["dv"] += torch.einsum("bhqk,bhqd->bhkd", pk, dc)
        out["dk"] += torch.einsum("bhqk,bhqd->bhkd", dsk, qc) * scale
        out["dq"][:, :, rows] = torch.einsum("bhqk,bhkd->bhqd", dsq,
                                             kd) * scale
        if drop is None:   # the rule's term bounds (module docstring)
            dot_err = D * 2.0 ** -24
            e_p = (2.0 ** -16 + cf.abs() * dot_err * scale * torch.einsum(
                "bhqd,bhkd->bhqk", qc.abs(), kd.abs()))
            term = 2.0 ** -8 + e_p
            e_ds = (term * ds.abs() + p * cf.abs() * dot_err * (
                torch.einsum("bhqd,bhkd->bhqk", dc.abs(), vd.abs())
                + (dc.abs() * oc.abs()).sum(-1, keepdim=True)))
            if softcap > 0:
                e_ds = e_ds + 2.0 ** -20 * p * dpd.abs()
            out["a_dv"] += torch.einsum("bhqk,bhqd->bhkd", p * term,
                                        dc.abs())
            out["a_dk"] += torch.einsum("bhqk,bhqd->bhkd", e_ds,
                                        qc.abs()) * scale
            out["a_dq"][:, :, rows] = torch.einsum(
                "bhqk,bhkd->bhqd", e_ds, kd.abs()) * scale
    for n in ("dk", "dv", "a_dk", "a_dv"):
        out[n] = out[n].reshape(B, Hkv, G, Skv, D).sum(dim=2)
    return out


LOG2E = 1.4426950408889634


def emulated_backward(q, k, v, o, lse, do, *, kv_len=None, q_offset=None,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None,
                      tiles_of: Optional[int] = None) -> tuple:
    """The backward kernels' arithmetic on CPU tensors, in their tile order
    (``bwd_loops`` at head dim ``tiles_of``, default q's): delta and lse
    log2(e) in float32; per tile, S and dP in float32 from the bf16
    operands, P = 2^(s log2(e) - lse log2(e)) (0 on a masked pair) and
    dS = P (dP - delta) cf in float32, each rounded to bf16 as the operand
    of dV += P^T dO, dK += dS^T Q or dQ += dS K, whose sums are float32
    (a tile's product, then the running sum); dK and dQ scaled at the end.
    Returns bf16 ``(dq, dk, dv)``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32, bf16 = torch.float32, torch.bfloat16

    def c(x):
        return torch.tensor(x, dtype=f32)

    scale = float(scale if scale is not None else D ** -0.5)
    c1 = c(scale) * c(LOG2E)
    c2 = c(2.0) * c(scale) * c(LOG2E) / c(softcap) if softcap > 0 else None
    c3 = c(softcap) * c(LOG2E)
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    lse2 = lse.to(f32) * c(LOG2E)
    delta = (dof * o.to(f32)).sum(-1)
    dq = torch.zeros((B, Hq, Sq, D), dtype=f32)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=f32)
    dv = torch.zeros_like(dk)
    r = BWD_STAGE_ROWS
    outer = BWD_BLOCK_ROWS[tiles_of or D]
    off = q_offset or 0

    def p_ds(s, dp, rows_l, rows_d, q0, k0, kvl):
        """P and dS of a [.., queries, keys] tile at query row q0, key k0."""
        if softcap > 0:
            t = 1 - 2 / (torch.exp2(s * c2) + 1)
            cf = 1 - t * t
            pe = torch.exp2(c3 * t - rows_l[..., None])
        else:
            cf = 1.0
            pe = torch.exp2(s * c1 - rows_l[..., None])
        qpos = off + q0 + torch.arange(s.shape[-2]).reshape(-1, 1)
        kpos = k0 + torch.arange(s.shape[-1])
        m = kpos < kvl
        if causal:
            m = m & (qpos >= kpos)
        if window > 0:
            m = m & (qpos - kpos < window)
        pe = torch.where(m, pe, torch.zeros((), dtype=f32))
        return pe, pe * (dp - rows_d[..., None]) * cf

    def operand(x):
        return x.to(bf16).to(f32)

    for b, kvl in enumerate(_row_kv_lens(B, Skv, kv_len)):
        loops = bwd_loops(Sq, Skv, tiles_of or D, kvl, off, causal, window,
                          G)
        for k0, its in loops["dkdv"]:
            ks, vs = kf[b, :, k0:k0 + outer], vf[b, :, k0:k0 + outer]
            for g, q0 in its:
                heads = torch.arange(Hkv) * G + g
                qs = qf[b, heads, q0:q0 + r]
                ds_ = dof[b, heads, q0:q0 + r]
                pe, dsv = p_ds(qs @ ks.transpose(1, 2),
                               ds_ @ vs.transpose(1, 2),
                               lse2[b, heads, q0:q0 + r],
                               delta[b, heads, q0:q0 + r], q0, k0, kvl)
                dv[b, :, k0:k0 + outer] += operand(pe).transpose(1, 2) @ ds_
                dk[b, :, k0:k0 + outer] += operand(dsv).transpose(1, 2) @ qs
        kx = kf[b].repeat_interleave(G, dim=0)
        vx = vf[b].repeat_interleave(G, dim=0)
        for q0, kts in loops["dq"]:
            qs, ds_ = qf[b, :, q0:q0 + outer], dof[b, :, q0:q0 + outer]
            for k0 in kts:
                ks, vs = kx[:, k0:k0 + r], vx[:, k0:k0 + r]
                _, dsv = p_ds(qs @ ks.transpose(1, 2),
                              ds_ @ vs.transpose(1, 2),
                              lse2[b, :, q0:q0 + outer],
                              delta[b, :, q0:q0 + outer], q0, k0, kvl)
                dq[b, :, q0:q0 + outer] += operand(dsv) @ ks
    return ((dq * scale).to(bf16), (dk * scale).to(bf16), dv.to(bf16))


BWD_ELEMENT_ULPS = 2.0 ** -7    # of the element's own |r|


def grad_excess(got: torch.Tensor, ref: torch.Tensor,
                bound: torch.Tensor) -> float:
    """The largest ``|got - ref|`` over ``2^-7 |ref| + bound`` (``bound``
    the reference's ``a_*``; pass at <= 1); an element of allowance 0
    counts as 0 if it equals ``ref`` exactly and as infinity if not."""
    r = ref.to(torch.float64)
    err = (got.to(torch.float64) - r).abs()
    allow = BWD_ELEMENT_ULPS * r.abs() + bound
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    # sync: a check's verdict, read once per comparison (tests, chip_smoke)
    return float(ratio.max()) if ratio.numel() else 0.0
