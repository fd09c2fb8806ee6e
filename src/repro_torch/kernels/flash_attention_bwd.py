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

Two routes, chosen by :func:`backward_route` from dtype and width (each
serves its inputs; neither is a fallback of the other):

* ``"wgmma"``: bfloat16 at hd <= 128 (phi3-mini's 96 on the training
  path) runs on Hopper's tensor cores.  A pre-pass sums ``delta =
  rowsum(dout * out)`` (and lays it and ``lse`` out per head), a
  ``dkdv`` kernel walks the query tiles (64 a stage) for each tile of 128
  keys and writes dk and dv, a ``dq`` kernel walks the key tiles (64 a
  stage) for each tile of 128 queries and writes dq; a warpgroup takes 64
  of a block's keys or rows.  S and dP are computed in both: dq is a pass
  of its own so that it needs no atomics, whose order changes from run
  to run, and two calls on the same inputs give the same bits.  That
  makes seven products, 2 (4 hd + 3 hd_v) operations per unmasked pair:
  at phi3's training shape 360.8 GFLOP, 0.365 ms at the bf16 tensor-core
  rate, which bounds it (operations).  At hd 96 a block holds ~130 KB of
  shared memory and a consumer thread dK and dV (96 floats) beside S and
  dP (64), within the 232 registers a ``setmaxnreg`` gives it.  P and dS
  are rounded to bfloat16 for their products; every sum is float32.  The
  tiles load by TMA or, where a base address or stride is not 16-byte
  aligned (hd 20 in bfloat16), by plain loads: ``load_width(q, k, v,
  dout)``, the forward's rule.
* ``"cuda_cores"``: float32 at any width, and bfloat16 at hd > 128
  (MLA's 192/128, which no one-card training path reaches), run on the
  CUDA cores in float32: one kernel per 64 keys keeps dk and dv on chip,
  and a dq pass per 64 query rows walks the key tiles in ascending order,
  recomputing s and dp, and writes dq once in q's dtype.  Nothing is
  atomic: two calls on the same inputs give the same bits, on both routes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import (_DTYPES, MAX_HEAD_DIM, MAX_V_HEAD_DIM,
                              _strides, load_width)

__all__ = ["flash_attention_bwd_kernel", "backward_route"]

WGMMA_MAX_HD = 128     # the tensor-core route's widest q . k
PAD_ROWS = 128         # the tensor-core route lays lse and delta out per
                       # head over Sq rounded up to this


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor) -> tuple:
    """(route, load width) of a backward call: ``("wgmma", w)`` for
    bfloat16 at hd <= 128, where ``w`` is ``load_width(q, k, v, dout)``
    (16: TMA; 8, 4, 2: plain loads of that many bytes); ``("cuda_cores",
    0)`` for float32 and for bfloat16 at a wider hd.  Reads shapes,
    strides and addresses only: nothing is launched."""
    if q.dtype == torch.bfloat16 and q.shape[3] <= WGMMA_MAX_HD:
        return "wgmma", load_width(q, k, v, dout)
    return "cuda_cores", 0


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
    call, three kernels on either route) and to its route's entry of
    ``flash_attention_bwd_kernel.launches_by_route``.  There is no CPU path: a CPU tensor
    raises.
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
    if b * kvh > 65535:
        raise ValueError(f"flash_attention_bwd_kernel takes B * KV <= "
                         f"65535, got {b * kvh}")
    out, lse = out.contiguous(), lse.contiguous()
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    route, width = backward_route(q, k, v, dout)
    if route == "cuda_cores":       # it reads dout as laid out densely
        dout = dout.contiguous()
    dev = q.device
    if route == "wgmma":
        sq_pad = -(-sq // PAD_ROWS) * PAD_ROWS
        dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
        scratch = torch.empty((2, b * h, sq_pad), dtype=torch.float32,
                              device=dev)
    else:
        dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
        scratch = torch.empty((b, sq, h), dtype=torch.float32, device=dev)
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
flash_attention_bwd_kernel.launches_by_route = {"wgmma": 0, "cuda_cores": 0}
