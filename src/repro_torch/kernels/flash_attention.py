"""Causal or full GQA flash attention (forward) as hand-written CUDA
kernels.

Ports ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``flash_attention_kernel``).  The kernels are ``csrc/flash_attention.cu``;
its source note says what bounds them on the H100 and why they read q, k
and v in place where the TPU wrapper broadcast k and v per group and
padded hd in HBM.  Their plain version is ``kernels.ref.mha_reference``.

  q   (B, Sq, H, hd)      float32 or bfloat16, unit stride along hd
  k   (B, Skv, KV, hd)    q's dtype; H = KV * G, query head h reads kv head
                          h // G (the reference's (B, S, KV, G, hd) grouping)
  v   (B, Skv, KV, hd_v)  q's dtype
  out (B, Sq, H, hd_v)    contiguous, in q's dtype

``hd <= 192`` and ``hd_v <= min(hd, 128)``; anything else raises.  hd_v <
hd is DeepSeek-V2's MLA (``models.attention.mla_forward``): q . k over
nope + rope = 192, values 128 wide.

The kernel is chosen by dtype; neither is a fallback of the other:

* bfloat16 runs on the tensor cores (wgmma, K and V streamed by TMA
  through a ring of shared-memory stages).  Scores are ``scale * (q . k)``:
  the product in float32, then the scale.  P, the softmax numerators, is
  rounded to bfloat16 for the ``P . V`` product (the row sums stay float32).
  Where a base address or stride of q, k or v is not 16-byte aligned (hd 20
  in bfloat16 is a 40-byte row), TMA cannot load the tiles, and the same
  kernel loads them with the widest plain loads they allow
  (:func:`load_width`).
* float32 runs on the CUDA cores in float32 arithmetic: scores are
  ``(q * scale) . k`` (the model path's rounding: the Pallas wrapper
  rounded ``q * scale`` back to q's dtype first).

``scale = 1/sqrt(hd)`` (the q . k width), optionally soft-capped; key j
of query i is masked when ``j > i`` (causal; both positions start at 0).
``return_lse=True`` also returns each row's log-sum-exp (B, Sq, H),
float32, natural log: the residual of the backward kernel
(``kernels.flash_attention_bwd``).  This wrapper is the forward alone: an
input that requires grad raises, and ``kernels.ops.flash_attention`` pairs
it with the backward in a ``torch.autograd.Function`` for training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_kernel", "load_width", "MAX_HEAD_DIM",
           "MAX_V_HEAD_DIM"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 192      # hd is padded in shared memory (64, 128, 192 in bf16)
MAX_V_HEAD_DIM = 128    # hd_v, also at most hd


def _strides(t: torch.Tensor) -> tuple:
    """(batch, sequence, head) strides of a (B, S, heads, hd) tensor.  A
    dimension of size 1 is never stepped, so its stride is free: it is set
    to the dense value rounded up to 16 bytes, so that neither a view's odd
    stride there nor an odd hd keeps the tiles from TMA."""
    b, s, h, hd = t.shape
    sb, ss, sh, _ = t.stride()
    unit = 16 // t.element_size()

    def up(x):
        return -(-x // unit) * unit
    sh = up(hd) if h == 1 else sh
    ss = up(h * sh) if s == 1 else ss
    sb = up(s * ss) if b == 1 else sb
    return sb, ss, sh


def load_width(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *more: torch.Tensor) -> int:
    """How the bfloat16 kernels load the tiles of q, k and v (and of
    ``more`` (B, S, heads, hd_v) tensors, the backward's dout): 16 by TMA,
    when every base address and (batch, sequence, head) stride is 16-byte
    aligned and the strides nest (head inside sequence inside batch, as in
    a contiguous or fused-projection layout); else the widest plain load,
    8, 4 or 2 bytes, that divides every address, stride and the hd and
    hd_v rows."""
    elt = q.element_size()
    parts, nested = [], True
    for t in (q, k, v) + more:
        sb, ss, sh = _strides(t)
        parts += [t.data_ptr(), sb * elt, ss * elt, sh * elt]
        nested = nested and sh * t.shape[2] <= ss and \
            ss * t.shape[1] <= sb
    g = math.gcd(16, *parts)
    if g == 16 and nested:
        return 16
    g = math.gcd(g, 8, q.shape[3] * elt, v.shape[3] * elt)
    return 8 if g % 8 == 0 else 4 if g % 4 == 0 else 2


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, softcap: float = 0.0,
                           return_lse: bool = False):
    """q (B, Sq, H, hd), k (B, Skv, KV, hd) and v (B, Skv, KV, hd_v), one
    dtype (float32 or bfloat16) on one CUDA device, each with unit stride
    along its last axis -> (B, Sq, H, hd_v) attention output in q's dtype,
    and with ``return_lse`` also the (B, Sq, H) float32 log-sum-exp.  hd
    <= 192 and hd_v <= min(hd, 128), else ``ValueError``.

    Launches the kernel on the current stream and adds one to
    ``flash_attention_kernel.launches``.  There is no CPU path: a CPU tensor
    raises (``kernels.ops.flash_attention`` picks the plain version for
    those), and so does an input that requires grad (the wrapper has no
    backward of its own: ``ops.flash_attention`` trains through it).
    """
    tensors = (q, k, v)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention_kernel has no backward: call it "
                           "under torch.no_grad() or torch.inference_mode(), "
                           "or train through ops.flash_attention")
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_kernel runs on CUDA tensors only "
                         f"(got {[str(t.device) for t in tensors]})")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k and v must share one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3] or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"need q (B, Sq, H, hd), k (B, Skv, KV, hd) and v "
                         f"(B, Skv, KV, hd_v); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not split into groups over "
                         f"{kvh} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_kernel takes 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if not 1 <= hd_v <= min(hd, MAX_V_HEAD_DIM):
        raise ValueError(f"flash_attention_kernel takes 1 <= hd_v <= "
                         f"min(hd, {MAX_V_HEAD_DIM}), got hd {hd}, hd_v "
                         f"{hd_v}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash_attention_kernel needs unit stride along hd")
    if b * h > 65535:
        raise ValueError(f"flash_attention_kernel takes B * H <= 65535, got "
                         f"{b * h}")
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    lse = None
    if return_lse:
        lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        if skv == 0:       # no key: the kernels' empty row state
            lse.fill_(-1e30)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_int64 * 9)(*(s for t in tensors
                                     for s in _strides(t)))
    width = load_width(q, k, v) if q.dtype == torch.bfloat16 else 0
    launch = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if return_lse else None,
                     b, sq, skv, h, kvh, hd, hd_v, strides, 1.0 / hd ** 0.5,
                     float(softcap), int(bool(causal)), _DTYPES[q.dtype],
                     width, stream)
    _build.check(err, "flash_attention")
    flash_attention_kernel.launches += 1
    return (out, lse) if return_lse else out


flash_attention_kernel.launches = 0
