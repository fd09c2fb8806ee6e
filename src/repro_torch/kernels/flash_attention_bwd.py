"""The flash attention backward as hand-written CUDA kernels.

No TPU kernel is replaced: the reference's backward is XLA
(``_flash_bwd``, ``repro/models/attention.py:107``), the custom VJP of
its blockwise attention.  The forward on the card is the hand-written
``flash_attention`` kernel, so its backward is one too:
``csrc/flash_attention_bwd.cu`` (its source note says what bounds it and
how it is laid out).  Its plain version is
``kernels.ref.flash_attention_bwd_reference``; ``kernels.ops.
flash_attention`` pairs the two kernels in a ``torch.autograd.Function``.

  q, k, v           as the forward's (``kernels.flash_attention``)
  out, dout         (B, Sq, H, hd_v) in q's dtype
  lse               (B, Sq, H) float32, the forward's ``return_lse``
  -> dq, dk, dv     q's, k's and v's shapes, contiguous, in q's dtype

Two routes, both on Hopper's tensor cores, chosen by
:func:`backward_route` from the dtype (each serves its dtype; neither is a
fallback of the other).  Both sum dq in a pass of its own that walks the
key tiles in a fixed order, so that nothing is atomic and two calls on the
same inputs give the same bits; that pass recomputes s and dp.

* ``"wgmma"``: bfloat16 at every width (hd <= 192, hd_v <= 128) runs as
  bf16 wgmma.  A pre-pass sums ``delta = rowsum(dout * out)`` (and lays it
  and ``lse`` out per head), a ``dkdv`` kernel walks the query tiles (64 a
  stage; 32 at hd > 128) for each tile of 128 keys and writes dk and dv, a
  ``dq`` kernel walks the key tiles (64 a stage) for each tile of 128
  queries and writes dq; a warpgroup takes 64 of a block's keys or rows.
  Seven products, 2 (4 hd + 3 hd_v) operations per unmasked pair: at
  phi3's training shape 360.8 GFLOP, 0.365 ms at the bf16 tensor-core
  rate, which bounds it (operations).  The q . k width and the v width
  are template parameters apart, so MLA's hd_v 128 is not padded to 192.
  P and dS are rounded to bfloat16 for their products; every sum is
  float32.  The tiles load by TMA or, where a base address or stride is
  not 16-byte aligned (hd 20 in bfloat16), by plain loads: ``load_width(q,
  k, v, dout)``, the forward's rule.
* ``"3xtf32"``: float32 at every width runs as error-compensated 3xTF32
  wgmma, the float32 forward's arithmetic (``x = hi + lo``, each product
  ``lo . hi + hi . lo + hi . hi``, float32 sums; q scaled in float32
  before the split).  TF32 wgmma has no transpose bit, so a pre-pass
  writes q * scale, dout, k and v and the transposes of q * scale, dout and
  k as TF32 hi and lo planes into scratch this wrapper allocates
  (:func:`bwd_f32_planes` runs it alone).  Up to hd 96 one pass computes
  dv and dk (two warpgroups: one computes p and dv and hands p to the
  other, which computes ds and dk) and one dq (two warpgroups on
  alternate key tiles): seven products.  Above hd 96 a dv, a dk and a dq
  pass run one warpgroup each, the dv pass recomputing s (eight).  No
  wgmma accumulator sums over more than one tile: each tile's output
  product is added into float32 registers.  Its plain emulation is
  ``kernels.ref.flash_attention_bwd_3xtf32``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import (_DTYPES, MAX_HEAD_DIM, MAX_V_HEAD_DIM,
                              _strides, load_width)

__all__ = ["flash_attention_bwd_kernel", "backward_route", "bwd_f32_planes",
           "ROUTES"]

ROUTES = ("wgmma", "3xtf32")


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor) -> tuple:
    """(route, load width) of a backward call: ``("wgmma", w)`` for
    bfloat16, where ``w`` is ``load_width(q, k, v, dout)`` (16: TMA; 8, 4,
    2: plain loads of that many bytes); ``("3xtf32", 0)`` for float32 (the
    pre-pass reads the tensors through their strides).  Any other dtype
    raises ``TypeError``.  Reads dtypes, shapes, strides and addresses
    only: nothing is launched."""
    if q.dtype == torch.bfloat16:
        return "wgmma", load_width(q, k, v, dout)
    if q.dtype == torch.float32:
        return "3xtf32", 0
    raise TypeError(f"no backward route takes {q.dtype}")


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True,
                               softcap: float = 0.0) -> tuple:
    """dq, dk and dv of ``flash_attention_kernel(q, k, v, causal=causal,
    softcap=softcap)`` given its output ``out``, its ``lse`` and the
    output's gradient ``dout``.  One dtype (float32 or bfloat16) on one
    CUDA device; hd <= 192, hd_v <= min(hd, 128), Skv >= 1, else
    ``ValueError``.

    Launches the route's kernels (:func:`backward_route`) on the current
    stream and adds one to ``flash_attention_bwd_kernel.launches`` (one
    call: three kernels in bfloat16, the pre-pass and two or three passes
    in float32) and to its route's entry of
    ``flash_attention_bwd_kernel.launches_by_route``.  There is no CPU
    path: a CPU tensor raises, and so does what no route takes.
    """
    tensors = (q, k, v, out, dout)
    if not all(t.is_cuda for t in tensors + (lse,)):
        raise ValueError("flash_attention_bwd_kernel runs on CUDA tensors "
                         "only")
    if len({t.device for t in tensors + (lse,)}) != 1:
        raise ValueError("all inputs must share one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("q, k, v, out and dout must all be float32 or all "
                        "bfloat16")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3] or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, Sq, H, hd), k (B, Skv, KV, hd) and v "
                         f"(B, Skv, KV, hd_v); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if tuple(out.shape) != (b, sq, h, hd_v) or out.shape != dout.shape:
        raise ValueError(f"out and dout must be {(b, sq, h, hd_v)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if tuple(lse.shape) != (b, sq, h):
        raise ValueError(f"lse must be {(b, sq, h)}, got {tuple(lse.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not split into groups over "
                         f"{kvh} kv heads")
    if skv < 1 or sq < 1 or b < 1:
        raise ValueError(f"flash_attention_bwd_kernel needs B, Sq and Skv "
                         f">= 1, got {b}, {sq}, {skv}")
    if not 1 <= hd <= MAX_HEAD_DIM or \
            not 1 <= hd_v <= min(hd, MAX_V_HEAD_DIM):
        raise ValueError(f"flash_attention_bwd_kernel takes hd <= "
                         f"{MAX_HEAD_DIM} and hd_v <= min(hd, "
                         f"{MAX_V_HEAD_DIM}), got hd {hd}, hd_v {hd_v}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bwd_kernel needs unit stride "
                         "along hd")
    if b * h > 65535:
        raise ValueError(f"flash_attention_bwd_kernel takes B * H <= "
                         f"65535, got {b * h}")
    out, lse = out.contiguous(), lse.contiguous()
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    route, width = backward_route(q, k, v, dout)
    dev = q.device
    scratch = torch.empty(_scratch_extents(q, k, v)[0], dtype=torch.float32,
                          device=dev)
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((b, skv, kvh, hd), dtype=q.dtype, device=dev)
    dv = torch.empty((b, skv, kvh, hd_v), dtype=q.dtype, device=dev)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, dout)
                                      for s in _strides(t)))
    launch = _build.library("flash_attention_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), b, sq, skv, h, kvh, hd, hd_v, strides,
                     1.0 / hd ** 0.5, float(softcap), int(bool(causal)),
                     _DTYPES[q.dtype], width, stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd_kernel.launches += 1
    flash_attention_bwd_kernel.launches_by_route[route] += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def _scratch_extents(q, k, v) -> tuple:
    """(floats of scratch, Sq_pad, Skv_pad, hd_pad, hdv_pad) of a backward
    call, as the C side lays the scratch out
    (``flash_attention_bwd_scratch``; the last three are 0 in bfloat16)."""
    b, sq, h, hd = q.shape
    ext = (ctypes.c_int64 * 5)()
    err = _build.function("flash_attention_bwd_scratch")(
        b, sq, k.shape[1], h, k.shape[2], hd, v.shape[3], _DTYPES[q.dtype],
        ext)
    _build.check(err, "flash_attention_bwd_scratch")
    return tuple(ext)


def bwd_f32_planes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor,
                   dout: torch.Tensor) -> tuple:
    """The float32 backward's pre-pass alone, on float32 CUDA tensors with
    Skv >= 1: ``(lse2, delta, q * scale, dout, k, v, (q * scale)^T,
    dout^T, k^T)``.  ``lse2 = lse * log2(e)`` and ``delta = rowsum(dout *
    out)`` are (B * H, Sq_pad); the rest are TF32 hi and lo planes, rows
    (B * heads, 2, S_pad, width_pad) and transposed (B * heads, 2,
    width_pad, S_pad) with the sequence of every 8 in the kernels' order
    (0, 2, 4, 6, 1, 3, 5, 7), zero-padded.  Its plain version is
    ``kernels.ref.flash_bwd_f32_planes``; it counts no launch."""
    if q.dtype != torch.float32 or not q.is_cuda or k.shape[1] == 0:
        raise ValueError("bwd_f32_planes takes float32 CUDA tensors with "
                         "Skv >= 1")
    b, sq, h, hd = q.shape
    kvh, hd_v = k.shape[2], v.shape[3]
    total, sq_pad, skv_pad, hdp, nv = _scratch_extents(q, k, v)
    scratch = torch.empty(total, dtype=torch.float32, device=q.device)
    out, lse = out.contiguous(), lse.contiguous()
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, dout)
                                      for s in _strides(t)))
    with torch.cuda.device(q.device):
        err = _build.function("flash_attention_bwd_split")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), b, sq,
            k.shape[1], h, kvh, hd, hd_v, strides, 1.0 / hd ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_bwd_split")
    shapes = ((b * h, sq_pad), (b * h, sq_pad),
              (b * h, 2, sq_pad, hdp), (b * h, 2, sq_pad, nv),
              (b * kvh, 2, skv_pad, hdp), (b * kvh, 2, skv_pad, nv),
              (b * h, 2, hdp, sq_pad), (b * h, 2, nv, sq_pad),
              (b * kvh, 2, hdp, skv_pad))
    sizes = [math.prod(sh) for sh in shapes]
    assert sum(sizes) == total, (sizes, total)
    return tuple(p.view(sh) for p, sh in zip(scratch.split(sizes), shapes))
