"""Plain reference of a Berrut-coded training step of a dense decoder LM.

The model is the pre-norm decoder of phi-3-mini's description
(arXiv:2404.14219): token embedding; per layer RMSNorm, multi-head
attention with NeoX (half-rotation) RoPE and a causal mask, a residual
sum, RMSNorm, a SwiGLU FFN, a residual sum; a final RMSNorm and an
untied unembedding; the loss is the mean cross-entropy of the next
token.  The coded step (``src/repro_torch/launch/steps.py``'s
description, the paper's weighted-loss identity) views the global batch
as ``blocks`` row blocks of ``accum`` micro-batches, weights block n's
loss by the Berrut decode weight w_n of the step's responder mask, sums
the gradients over the micro-batches and divides by ``accum``; every
block's backward runs, a straggler's with w_n = 0.  Then AdamW with
global-norm clipping and a warmup-cosine learning rate.

Plain PyTorch in float32 with TF32 off (``precision="float32"``).  The
control (``precision="fp8"``) rounds both operands of every product to
float8 e4m3 and each product's incoming gradient to e5m2, each with a
per-tensor scale from its largest magnitude (the usual fp8 training
recipe), the rest as in float32.  It imports neither ``jax``, the JAX
package nor the port: the weights come from the benchmark's own maker
(``perfbench/lm_weights.py``), the block weights and the optimizer are
worked out here.  Frozen copies: the gradient code's nodes (``src/
repro_torch/core/berrut.py:61``, N = K = blocks, T = 0) and its decode
weights (``src/repro_torch/core/spacdc.py:161``, ``coded_training.py:
125``: the mean over the K block nodes of the masked Berrut decode,
times the mask); AdamW and the schedule (``src/repro_torch/optim/
optimizers.py``: ``adamw``, ``warmup_cosine``, ``clip_by_global_norm``).

The backward is taken layer by layer: the forward keeps each layer's
input only, and each layer is run again under autograd in the backward
(so that one layer's activations live at a time).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import lm_weights
from perfbench.reference.spacdc_round import berrut_matrix, node_layout


# ---- products in the chosen precision -----------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (float8) under a per-tensor scale."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul_of(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


# ---- the model ------------------------------------------------------------

def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, H, hd), positions 0..S-1: NeoX half rotation."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    c, sn = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


class Model:
    """The forward of one layer and of the head, over a dict of float32
    leaves named as ``lm_weights`` names them."""

    def __init__(self, cfg: dict, params: dict, precision: str):
        self.cfg, self.p = cfg, params
        self.mm = matmul_of(precision)
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]

    def layer(self, i: int, x):
        p, mm, cfg = self.p, self.mm, self.cfg
        pre = f"layers.{i}."
        b, s, d = x.shape
        hq, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        h = rms_norm(x, p[pre + "norm1.scale"], self.eps)
        wq, wk, wv = (p[pre + f"mixer.{n}"] for n in ("wq", "wk", "wv"))
        hd = wq.shape[-1]
        q = rope(mm(h, wq.reshape(d, -1)).view(b, s, hq, hd), self.theta)
        k = rope(mm(h, wk.reshape(d, -1)).view(b, s, kv, hd), self.theta)
        v = mm(h, wv.reshape(d, -1)).view(b, s, kv, hd)
        rep = hq // kv
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
        o = mm(probs, v).transpose(1, 2).reshape(b, s, hq * hd)
        x = x + mm(o, p[pre + "mixer.wo"].reshape(hq * hd, d))
        h2 = rms_norm(x, p[pre + "norm2.scale"], self.eps)
        f = F.silu(mm(h2, p[pre + "ffn.w_gate"])) * mm(h2, p[pre + "ffn.w_up"])
        return x + mm(f, p[pre + "ffn.w_down"])

    def head_loss(self, x, targets):
        p = self.p
        h = rms_norm(x, p["final_norm.scale"], self.eps)
        logits = self.mm(h, p["embedding.unembed"])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    def loss_backward(self, tokens, targets, weight) -> float:
        """The loss of one micro-batch; ``weight`` times its gradient is
        added to every leaf's ``.grad``, one layer's activations at a
        time."""
        n_layers = self.cfg["num_hidden_layers"]
        table = self.p["embedding.table"]
        with torch.no_grad():
            xs = [table[tokens]]
            for i in range(n_layers):
                xs.append(self.layer(i, xs[-1]))
        x = xs.pop().requires_grad_()
        loss = self.head_loss(x, targets)
        (weight * loss).backward()
        g = x.grad
        for i in reversed(range(n_layers)):
            x = xs.pop().requires_grad_()
            self.layer(i, x).backward(g)
            g = x.grad
        with torch.no_grad():
            table.grad.index_add_(0, tokens.reshape(-1),
                                  g.reshape(-1, g.shape[-1]))
        return float(loss.detach())


# ---- the coded step and AdamW ---------------------------------------------

def block_weights(blocks: int, mask) -> np.ndarray:
    """(blocks,) w_n: the mean over the K block nodes of the Berrut decode
    over the responders, 0 for a straggler."""
    alphas, betas = node_layout(blocks, blocks, 0)
    mask = np.asarray(mask) > 0
    resp = np.flatnonzero(mask)
    w = np.zeros(blocks)
    w[resp] = berrut_matrix(betas[:blocks], alphas[resp]).mean(axis=0)
    return w


def learning_rate(opt: dict, step: int) -> float:
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    frac = opt["final_frac"]
    return peak * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * prog)))


class Trainer:
    """The reference's own parameters, gradients and AdamW moments, made
    from the benchmark's weights, and its coded steps."""

    def __init__(self, cfg: dict, seed: int, device, precision="float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.device = cfg, seed, device
        self.opt = cfg["optimizer"]
        self.specs = lm_weights.chunk_specs(cfg)
        self.params = {}
        for c, specs in enumerate(self.specs):
            for name, t in lm_weights.make_chunk(torch, specs, seed, c,
                                                 device).items():
                self.params[name] = t.clone().requires_grad_()
        for p in self.params.values():
            p.grad = torch.zeros_like(p)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.model = Model(cfg, self.params, precision)
        self.step_count = 0

    def step(self, tokens, targets, mask, blocks: int, accum: int,
             rows: str = "all") -> float:
        """One coded step on (rows, S) tokens; returns the mean of the
        rows' unweighted losses.  ``rows="half"`` plants a fault: only
        the first half of the micro-batches enter, the mean taken over
        them."""
        for p in self.params.values():
            p.grad.zero_()
        w = block_weights(blocks, mask)
        losses = []
        used = max(accum // 2, 1) if rows == "half" else accum
        for a in range(used):
            for n in range(blocks):
                row = n * accum + a
                losses.append(self.model.loss_backward(
                    tokens[row:row + 1], targets[row:row + 1],
                    torch.tensor(float(w[n]), device=self.device)))
        self._adamw(used)
        return float(np.mean(losses))

    @torch.no_grad()
    def _adamw(self, accum: int) -> None:
        opt = self.opt
        for p in self.params.values():
            p.grad.div_(accum)
        norm = math.sqrt(sum(float(torch.sum(p.grad * p.grad))
                             for p in self.params.values()))
        clip = opt["max_grad_norm"]
        scale = min(1.0, clip / max(norm, 1e-9)) if clip else 1.0
        self.step_count += 1
        t = self.step_count
        lr = learning_rate(opt, t)
        b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], \
            opt["weight_decay"]
        for n, p in self.params.items():
            g = p.grad * scale
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).add_(g * g, alpha=1 - b2)
            mhat = self.mu[n] / (1 - b1 ** t)
            vhat = self.nu[n] / (1 - b2 ** t)
            p.sub_(lr * (mhat / (vhat.sqrt() + eps) + wd * p))

    def grad_norms(self) -> dict:
        """Each leaf's norm of the last step's gradient as the optimizer
        took it (after clipping), from its first moment: exact after the
        first step, when mu = (1 - b1) g."""
        b1 = self.opt["b1"]
        return {n: float(torch.linalg.vector_norm(m)) / (1 - b1)
                for n, m in self.mu.items()}

    def change_norms(self) -> dict:
        return {n: float(v) for n, v in lm_weights.change_norms(
            torch, self.params, self.cfg, self.seed, self.device,
            self.specs).items()}


def norm_gap(got: dict, want: dict, keep=None) -> tuple:
    """(the worst leaf's |got - want| over the larger of want's norm of
    that leaf and of the median leaf, that leaf's name)."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names]))
    gaps = {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
