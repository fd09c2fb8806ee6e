"""Per-device cost analysis of one rank's dispatched ops: FLOPs, HBM bytes,
collective bytes and the peak of live bytes.

The counterpart of ``repro/launch/hlo_analysis.py`` (its name is kept so
that a reader finds it).  The reference parses the compiled per-device
HLO and weights loop bodies by their trip counts.  The port has no HLO:
``analyze(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` that sees
the ops this rank dispatches on its local tensors (a DTensor op is
answered ``NotImplemented``, so the mode sees what DTensor runs locally
and the collectives it issues, as ``dist.collectives.InPlace`` does).  On
meta tensors over a fake process group (``launch.dryrun``) nothing is
allocated and nothing is sent.  Only ops on the device of ``fn``'s first
tensor argument count (the mesh's own bookkeeping runs on the host), and
none on fake tensors (DTensor's sharding propagation runs an op it has not
seen on global-shaped fake tensors to learn its output's shape).

* flops — 2·|out|·K for ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` (K the
  contracted extent), 2·|out|·window for convolutions (the window is the
  kernel's spatial extent, as the reference counts a convolution; the
  weight gradient's window is the output's length), 0 for elementwise
  ops, as the reference counts dots.
* hbm bytes — operands plus result of every op that materializes its
  result; views (``view``, ``expand``, ``as_strided``, the transposes and
  slices that return views) and ``empty`` are free.  Eager's counterpart
  of the reference's "traffic across fusion boundaries": every op is a
  boundary here, so the number is larger than a fused program's (ROADMAP
  §3, different by design).
* collective bytes and counts — result-shape bytes by the reference's
  five kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``), for the functional collectives
  DTensor issues and the in-place ones the port calls itself.  These are
  not ``dist.collectives.stats()``'s input bytes.
* the hand kernels (``kernels.ops.flash_attention`` with its backward,
  ``coded_matmul``, ``berrut_combine``, ``mask_add``) count by their own
  formulas, the FLOPs and bytes of ``PERF.md`` §6's bounds (causal
  attention over the pairs its mask keeps, about half of them): the plain
  version that runs in their place on meta tensors is not counted (it
  would count a (B, H, S, S) score matrix in bytes).  They take meta
  tensors only: an analysis that reaches one with a tensor on any other
  device raises, on the card as on the host, so that no plain version
  ever runs in a kernel's place.
* peak_bytes — the most bytes that op results held at once during
  ``fn`` (each result counted from its op to its release, through a
  ``weakref.finalize``; views and in-place results hold none of their
  own).  Tensors alive before ``fn`` (its arguments) are not counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Metrics", "COLLECTIVES", "analyze", "flash_work",
           "flash_bwd_work"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# (namespace, op base name) -> (kind, the argument holding the result
# (None: the op's own), the argument holding the group)
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", None, 2),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", None,
                                                    3),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", None, 3),
    ("c10d", "allreduce_"): ("all-reduce", 0, 1),
    ("c10d", "_allgather_base_"): ("all-gather", 0, 2),
    ("c10d", "allgather_"): ("all-gather", 0, 2),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 0, 2),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 0, 2),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 0, 2),
    ("c10d", "alltoall_base_"): ("all-to-all", 0, 2),
    ("c10d", "send"): ("collective-permute", 0, 1),
}
NODE = 8        # ranks a node: a group inside one is on NVLink
_FREE = {"empty", "empty_like", "new_empty", "empty_strided",
         "new_empty_strided", "_local_scalar_dense", "wait_tensor",
         "_wrap_tensor_autograd", "detach", "lift_fresh", "set_", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type", "_to_copy_meta"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm"}


@dataclasses.dataclass
class Metrics:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    # result bytes by the span of the collective's group: "node" (every
    # rank in one node of NODE) or "cross_node"
    span_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"node": 0.0, "cross_node": 0.0})
    peak_bytes: float = 0.0

    def add(self, other: "Metrics", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for k in COLLECTIVES:
            self.collective_bytes[k] += other.collective_bytes[k] * mult
            self.collective_counts[k] += other.collective_counts[k] * mult
        for k in self.span_bytes:
            self.span_bytes[k] += other.span_bytes[k] * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(node):
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, (list, tuple)):
        for child in node:
            yield from _tensors(child)
    elif isinstance(node, dict):
        for child in node.values():
            yield from _tensors(child)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a causal mask keeps (query i sees keys 0..i, as
    the kernel's implicit positions: sum_i min(skv, i + 1)), or all."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def flash_work(b, sq, skv, h, kv, hd, hd_v, causal, elt) -> tuple:
    """(bytes, FLOPs) of one flash forward, as ``chip_smoke.flash_work``:
    q, k, v read and out written once; both products over the kept
    pairs."""
    return (elt * (b * sq * h * (hd + hd_v) + b * skv * kv * (hd + hd_v)),
            2 * b * h * (hd + hd_v) * _pairs(sq, skv, causal))


def flash_bwd_work(b, sq, skv, h, kv, hd, hd_v, causal, elt) -> tuple:
    """(bytes, FLOPs) of one flash backward, as ``chip_smoke.
    flash_bwd_work``'s five products: q, k, v, out, dout and the float32
    lse read, dq, dk, dv written."""
    nbytes = elt * (2 * b * sq * h * (hd + hd_v) +
                    2 * b * skv * kv * (hd + hd_v)) + 4 * b * sq * h
    return nbytes, b * h * 2 * (3 * hd + 2 * hd_v) * _pairs(sq, skv, causal)


def _span(group) -> str:
    """"node" when every rank of ``group`` (a group name, a process group
    or its boxed form) lies in one node of ``NODE`` ranks, else
    "cross_node"."""
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):
        group = dist.ProcessGroup.unbox(group)
    nodes = {r // NODE for r in dist.get_process_group_ranks(group)}
    return "node" if len(nodes) == 1 else "cross_node"


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``analyze``."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.m = Metrics()
        self.live = 0
        self.suspended = 0

    # ---- live bytes
    def _release(self, nbytes: int) -> None:
        self.live -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.m.peak_bytes = max(self.m.peak_bytes, self.live)
        weakref.finalize(t, self._release, n)

    # ---- counting
    def kernel(self, flops: float, nbytes: float) -> None:
        self.m.flops += flops
        self.m.hbm_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            # DTensor's sharding propagation infers an op's output on
            # global-shaped fake tensors: no rank runs that
            return out
        ns = func.namespace
        base = func.name().split("::")[-1].split(".")[0]
        coll = _COLLECTIVE_OPS.get((ns, base))
        if coll is not None:
            kind, arg, grp = coll
            res = outs if arg is None else list(_tensors(args[arg]))
            nbytes = sum(_nbytes(t) for t in res)
            self.m.collective_bytes[kind] += nbytes
            self.m.collective_counts[kind] += 1
            self.m.span_bytes[_span(args[grp])] += nbytes
            self.m.hbm_bytes += nbytes + sum(_nbytes(t) for t in ins
                                             if not any(t is r for r in res))
            if arg is None:
                for t in outs:
                    self._hold(t)
            return out
        if func.is_view or base in _FREE or ns in ("c10d",
                                                   "_c10d_functional"):
            return out
        if base in _DOTS:
            a = args[1] if base in ("addmm", "baddbmm") else args[0]
            self.m.flops += 2.0 * outs[0].numel() * a.shape[-1]
        elif base == "convolution":
            window = math.prod(args[1].shape[2:])
            self.m.flops += 2.0 * outs[0].numel() * window
        elif base == "convolution_backward":
            # (grad_output, input, weight, ..., output_mask): the input's
            # gradient over the kernel's window, the weight's over the
            # output's length
            grad_out, inp, weight, mask = args[0], args[1], args[2], args[-1]
            if mask[0]:
                self.m.flops += 2.0 * inp.numel() * \
                    math.prod(weight.shape[2:])
            if mask[1]:
                self.m.flops += 2.0 * weight.numel() * \
                    math.prod(grad_out.shape[2:])
        self.m.hbm_bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if not aliased:
            for t in outs:
                self._hold(t)
        return out


_ACTIVE: list = []


@contextlib.contextmanager
def _suspended():
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is not None:
        counter.suspended += 1
    try:
        yield counter
    finally:
        if counter is not None:
            counter.suspended -= 1


class _PlainFlash(torch.autograd.Function):
    """The plain flash version, counted by the kernels' formulas: forward
    by ``flash_work``, backward by ``flash_bwd_work``; their own ops
    uncounted."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap):
        from ..kernels import ref
        with _suspended() as counter:
            out, lse = ref.mha_reference(q, k, v, causal=causal,
                                         softcap=softcap, return_lse=True)
        if counter is not None:
            counter.kernel(*_flash_formula(q, k, v, causal, False)[::-1])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softcap = causal, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..kernels import ref
        q, k, v, out, lse = ctx.saved_tensors
        with _suspended() as counter:
            dq, dk, dv = ref.flash_attention_bwd_reference(
                q, k, v, out, lse, dout, causal=ctx.causal,
                softcap=ctx.softcap)
        if counter is not None:
            counter.kernel(*_flash_formula(q, k, v, ctx.causal,
                                           True)[::-1])
        return dq, dk, dv, None, None


def _flash_formula(q, k, v, causal, backward: bool) -> tuple:
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    fn = flash_bwd_work if backward else flash_work
    return fn(b, sq, skv, h, kvh, hd, hd_v, causal, q.element_size())


def _refuse_launch(*tensors) -> None:
    """Under ``analyze`` a hand kernel takes meta tensors only, whatever
    the analyzed device: on any other tensor it would launch, or run its
    plain version in the kernel's place."""
    if any(isinstance(t, torch.Tensor) and t.device.type != "meta"
           for t in tensors):
        raise RuntimeError("a dry run launches no kernel: a hand kernel "
                           "was given a tensor off the meta device")


@contextlib.contextmanager
def _hand_kernels():
    """``kernels.ops``' hand-kernel entry points replaced for the block by
    versions counted by formula (DTensor calls pass through: their local
    calls come back here)."""
    from ..kernels import ops
    orig = {name: getattr(ops, name) for name in
            ("flash_attention", "coded_matmul", "berrut_combine",
             "mask_add")}

    def flash(q, k, v, *, causal=True, softcap=0.0, force_kernel=None):
        if type(q).__name__ == "DTensor":
            return orig["flash_attention"](q, k, v, causal=causal,
                                           softcap=softcap,
                                           force_kernel=force_kernel)
        _refuse_launch(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _PlainFlash.apply(q, k, v, causal, softcap)
        with _suspended() as counter:
            out = orig["flash_attention"](q, k, v, causal=causal,
                                          softcap=softcap, force_kernel=False)
        if counter is not None:
            counter.kernel(*_flash_formula(q, k, v, causal, False)[::-1])
        return out

    def counted(name, formula):
        def fn(*args, **kwargs):
            _refuse_launch(*args)
            with _suspended() as counter:
                out = orig[name](*args, **kwargs)
            if counter is not None:
                counter.kernel(*formula(*args))
            return out
        return fn

    def coded(w, blocks, rhs, **_):
        n, j = w.shape
        blk, d = blocks.shape[1], blocks.shape[-1]
        n_out, elt = rhs.shape[-1], blocks.element_size()
        return (2 * n * j * blk * d + 2 * n * blk * d * n_out,
                4 * n * j + elt * (j * blk * d + d * n_out + n * blk * n_out))

    def combine(w, blocks, **_):
        q, j = torch.as_tensor(w).shape
        m = blocks.numel() // j
        return 2 * q * j * m, 4 * q * j + blocks.element_size() * (
            j * m + q * m)

    def mask(payload, mask_, *_, **__):
        return 0, 3 * _nbytes(payload)

    ops.flash_attention = flash
    ops.coded_matmul = counted("coded_matmul", coded)
    ops.berrut_combine = counted("berrut_combine", combine)
    ops.mask_add = counted("mask_add", mask)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)


def analyze(fn, *args, device_type: Optional[str] = None,
            **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once and return (its result, the
    per-device ``Metrics`` of the ops this rank dispatched on
    ``device_type``: by default the device of the first tensor among
    ``args``, a DTensor's local one)."""
    if device_type is None:
        first = next(_tensors(args), None)
        if first is not None and type(first).__name__ == "DTensor":
            first = first.to_local()
        device_type = first.device.type if first is not None else "cpu"
    counter = _Counter(device_type)
    _ACTIVE.append(counter)
    try:
        with _hand_kernels(), counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return out, counter.m
