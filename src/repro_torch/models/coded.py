"""Coded per-step projections for serving: Eq.-23 generalized to the model.

Ports ``repro/models/coded.py``.  The paper's coded matmul computes
``y = x @ W`` as a row-block-coded job on ``A = W^T``: the master encodes
A's row blocks once, worker *n* holds shard ``C[n]`` (blk, d_in) and per
step computes ``C[n] @ x^T``; any decodable responder prefix reconstructs
``y^T``.  Every per-step projection the ``ServeSpec`` selects runs so:

* ``qkv`` — attention q|k|v stacked (they share the post-norm input);
  for MLA, wq|w_dkv;
* ``o``   — the output projection (``wo`` flattened to 2-D);
* ``up``  — FFN up (gate|up stacked for swiglu);
* ``down``— FFN down;
* the unembed (always coded unless ``coded_layers="none"``).

Weights are encoded **once** at serve start (they are what lives on the
workers); only activations move per step.  All sites of a step share ONE
straggler plan and ONE decode mask: the whole step is one coded round.
The mask, the per-slot positions and the per-site wire material
(``encrypt="real"``) are arguments of the step, so admission and eviction
churn and responder churn never rebuild anything.

The non-matmul ops (bias, qk-norm, RoPE, softmax, activations, norms)
stay on the master, shared op for op with the plain decode path through
the projection hooks of ``models.attention`` and ``models.layers``.

Differences from the reference, by design:

* **One shard stack per layer.**  The reference scans stacked groups of
  layers and keeps ``(G, N, blk, d)`` shards per group position; the port
  loops over an ``nn.ModuleList`` and keeps one ``(N, blk, d)`` stack per
  layer and site.  Wire material is still assigned in the reference's
  order (prelude layers, then each group position's sites over its G
  layers), so a step draws its nonces as the reference's does.
* **Explicit noise.**  The reference draws the T noise blocks of every
  site as ``noise_scale · normal(PRNGKey(cfg.seed))``; the port's scheme
  draws its own from a seeded ``torch.Generator``, and
  ``encode_serving_weights(noise=...)`` takes them explicitly, so parity
  tests at T > 0 can hand in the reference's.
* **The worker products** of a site are one float32 ``torch.bmm`` over the
  activations broadcast to every worker (IEEE: the package never turns
  TF32 on), in ``ops.precoded_matmul``.  The in-step wire is that
  function's ``wire`` hook: each worker gets its own decrypted copy of
  the activations, bit-identical to the broadcast, through the same
  ``bmm``, so the encrypted step equals the plain coded step bit for bit.
* **The wire's kernel** follows the scheme's ``use_kernel`` tri-state,
  as every port round does: None = the ``mask_add`` kernel for CUDA
  tensors.  The reference's in-step wire takes its Pallas kernel only
  when forced (``models/coded.py:359``).
* MoE FFNs and SSM mixers stay uncoded in both packages (data-dependent
  routing, recurrence); MLA's per-head latent maps ``w_uk``/``w_uv`` stay
  on the master, as in the reference.

Each coded site's decode is one ``berrut_combine`` launch on the card:
one per step for ``coded_layers="unembed"``, 4·L + 1 for ``"all"`` on a
dense model (2 per MLA layer with a MoE FFN, 4 per layer with a dense
one, + 1: 57 for the full deepseek-v2-lite-16b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_norm, dtype_of, embed, unembed
from .transformer import layer_desc

__all__ = ["SiteMeta", "ServingCode", "layer_sites", "encode_serving_weights",
           "coded_step_logits", "build_coded_step", "coded_flop_fraction"]

# deterministic site iteration order (material assignment, t_comp sums)
SITE_ORDER = ("qkv", "o", "up", "down")


@dataclasses.dataclass(frozen=True)
class SiteMeta:
    """Static description of one coded projection site ``y = x @ W``."""
    name: str
    d_in: int
    d_out: int                    # true output width (pre block padding)
    split: Tuple[int, ...]        # stacked projection widths (Σ == d_out)
    blk: int = 0                  # coded shard rows (set at encode time)


def _ordered(metas: Dict[str, SiteMeta]):
    return [n for n in SITE_ORDER if n in metas]


def layer_sites(cfg: ModelConfig, desc,
                coded_layers: str) -> Dict[str, SiteMeta]:
    """The coded sites of one layer under a ``coded_layers`` setting.

    MoE and SSM mixers have no fixed ``x @ W`` to pre-encode and stay
    uncoded (they only show up in the FLOP-fraction denominator); MLA's
    sites are wq|w_dkv and wo."""
    sites: Dict[str, SiteMeta] = {}
    want_attn = coded_layers in ("attn", "all")
    want_ffn = coded_layers in ("ffn", "all")
    d = cfg.d_model
    if want_attn and desc.mixer == "attn":
        hd, hq, kv = cfg.head_dim_, cfg.n_heads_padded, cfg.n_kv_heads_padded
        sites["qkv"] = SiteMeta("qkv", d, (hq + 2 * kv) * hd,
                                (hq * hd, kv * hd, kv * hd))
        sites["o"] = SiteMeta("o", hq * hd, d, (d,))
    elif want_attn and desc.mixer == "mla":
        h = cfg.n_heads_padded
        qw = h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        dkv = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        sites["qkv"] = SiteMeta("qkv", d, qw + dkv, (qw, dkv))
        sites["o"] = SiteMeta("o", h * cfg.v_head_dim, d, (d,))
    if want_ffn and desc.ffn == "dense":
        ff = cfg.d_ff
        if cfg.activation == "swiglu":
            sites["up"] = SiteMeta("up", d, 2 * ff, (ff, ff))
        else:
            sites["up"] = SiteMeta("up", d, ff, (ff,))
        sites["down"] = SiteMeta("down", ff, d, (d,))
    return sites


def _site_weight(layer, name: str, cfg: ModelConfig) -> torch.Tensor:
    """The stacked (d_in, d_out) weight matrix of one site, in compute
    dtype (the values the plain path multiplies by)."""
    cd = dtype_of(cfg, "compute")
    d = cfg.d_model
    if name == "qkv" and layer.desc.mixer == "mla":
        m = layer.mixer
        w = torch.cat([m["wq"].reshape(d, -1), m["w_dkv"]], dim=1)
    elif name == "qkv":
        m = layer.mixer
        w = torch.cat([m["wq"].reshape(d, -1), m["wk"].reshape(d, -1),
                       m["wv"].reshape(d, -1)], dim=1)
    elif name == "o":
        w = layer.mixer["wo"].reshape(-1, d)
    elif name == "up":
        f = layer.ffn
        w = (torch.cat([f["w_gate"], f["w_up"]], dim=1)
             if cfg.activation == "swiglu" else f["w_up"])
    else:                                                 # down
        w = layer.ffn["w_down"]
    return w.detach().to(cd)


@dataclasses.dataclass
class ServingCode:
    """Pre-encoded serving weights + static site metadata for one model.

    ``layer_meta[i]`` / ``layer_shards[i]``: layer i's sites and their
    (N, blk, d_in) float32 shards; ``unembed_meta`` / ``unembed_shards``
    the coded unembed (None for ``coded_layers="none"``).  ``n_pre``,
    ``period`` and ``n_groups`` are the reference's layer layout, which
    fixes the order wire material is assigned in."""
    coded_layers: str
    n_workers: int
    layer_meta: List[Dict[str, SiteMeta]]
    layer_shards: List[Dict[str, torch.Tensor]]
    unembed_meta: Optional[SiteMeta]
    unembed_shards: Optional[torch.Tensor]
    n_pre: int
    period: int
    n_groups: int

    def _instances(self):
        """(layer or None, name, meta) per coded site instance, in the
        reference's material-assignment order: the prelude layers, then
        each group position's sites, each over the G layers at that
        position, then the unembed."""
        for i in range(self.n_pre):
            for name in _ordered(self.layer_meta[i]):
                yield i, name, self.layer_meta[i][name]
        for p in range(self.period):
            first = self.n_pre + p
            for name in _ordered(self.layer_meta[first]):
                for g in range(self.n_groups):
                    i = first + g * self.period
                    yield i, name, self.layer_meta[i][name]
        if self.unembed_meta is not None:
            yield None, "unembed", self.unembed_meta

    @property
    def n_instances(self) -> int:
        """Coded site instances per step = wire-material pairs needed =
        ``berrut_combine`` launches per step on the card."""
        return sum(1 for _ in self._instances())

    def site_shapes(self, batch: int):
        """One (lhs, rhs) per site instance: the per-worker shard matmul
        ``C[n] (blk, d_in) @ x^T (d_in, B)`` — feeds the virtual clock's
        worker pricing (a worker runs all its shards back-to-back)."""
        return [((m.blk, m.d_in), (m.d_in, batch))
                for *_, m in self._instances()]

    def wire_elems(self, batch: int) -> Tuple[int, int]:
        """Per-channel wire payload element counts (out: activations to
        every worker; back: shard results) for crypto-time attribution."""
        out = back = 0
        for *_, m in self._instances():
            out += batch * m.d_in
            back += m.blk * batch
        return out, back

    def step_materials(self, engine) -> Dict[tuple, tuple]:
        """Fresh per-site wire material for ONE step: {(layer or None,
        name): (out, back)}, each (N, W) ``torch.uint32``."""
        keys = [(i, name) for i, name, _ in self._instances()]
        out, back = engine.serve_wire_material(len(keys))
        return {k: (out[j], back[j]) for j, k in enumerate(keys)}


def encode_serving_weights(scheme, model, coded_layers: str, *,
                           noise: Optional[Mapping] = None) -> ServingCode:
    """Once per Session × model: encode every selected site's ``W^T`` into
    its (N, blk, d_in) float32 worker shards on the model's device.

    ``noise`` (optional) maps ``(layer, name)`` — ``(None, "unembed")``
    for the unembed — to that site's (T, blk, d_in) noise blocks; a site
    without an entry gets the scheme's own draw."""
    cfg = model.cfg
    noise = noise or {}

    def enc(key, meta: SiteMeta, w2d) -> Tuple[SiteMeta, torch.Tensor]:
        a = w2d.to(torch.float32).T.contiguous()
        del w2d
        c = scheme.encode(a, noise.get(key))                 # (N, blk, d_in)
        return dataclasses.replace(meta, blk=int(c.shape[1])), c

    layer_meta, layer_shards = [], []
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            metas = layer_sites(cfg, layer_desc(cfg, i), coded_layers)
            shards = {}
            for name in _ordered(metas):
                metas[name], shards[name] = enc(
                    (i, name), metas[name], _site_weight(layer, name, cfg))
            layer_meta.append(metas)
            layer_shards.append(shards)

        unembed_meta = unembed_shards = None
        if coded_layers != "none":
            emb = model.embedding
            wt = emb["table"].T if cfg.tie_embeddings else emb["unembed"]
            unembed_meta = SiteMeta("unembed", cfg.d_model, cfg.vocab_size,
                                    (cfg.vocab_size,))
            unembed_meta, unembed_shards = enc(
                (None, "unembed"), unembed_meta,
                wt.detach().to(dtype_of(cfg, "compute")))
    return ServingCode(coded_layers=coded_layers, n_workers=scheme.n_workers,
                       layer_meta=layer_meta, layer_shards=layer_shards,
                       unembed_meta=unembed_meta,
                       unembed_shards=unembed_shards, n_pre=model.n_pre,
                       period=model.period, n_groups=model.n_groups)


# --------------------------------------------------------------------------
# the coded step
# --------------------------------------------------------------------------

def _coded_apply(c, x2d, dec_w, meta: SiteMeta, *, wire=None, mats=None,
                 force_kernel=None):
    """One coded site inside the step.  ``c`` (N, blk, d_in) pre-encoded
    shards; ``x2d`` (B, d_in); ``dec_w`` (K, N) masked decode weights.
    Returns (B, d_out) float32.

    With a wire (``encrypt="real"``) both transfers of the site cross the
    cipher: the activations out to every worker (each worker gets its own
    ciphertext of x) and the shard results back.  The bits codec keeps the
    round trip bit-identical, so the wired step equals the plain step."""
    b = x2d.shape[0]
    site_wire = None if wire is None else (
        lambda payload, leg: wire(payload, mats[leg]))
    dec = ops.precoded_matmul(c, x2d, dec_w, force_kernel=force_kernel,
                              wire=site_wire)
    return dec.reshape(-1, b)[: meta.d_out].T


def _layer_proj(cfg: ModelConfig, desc, metas, shards, dec_w, *, wire=None,
                mats=None, layer=None, force_kernel=None):
    """The ``proj`` dict for ``DecoderLayer.decode``: closures running this
    layer's coded sites against the step's shared decode weights.  ``desc``
    is the layer's ``LayerDesc``: an MLA layer's ``qkv`` returns (q, dkv)
    and its ``o`` maps (B, H v) to (B, d), as ``attention.mla_decode``
    takes them."""
    if not metas:
        return None
    cd = dtype_of(cfg, "compute")
    mats = mats or {}

    def run(name, x2d):
        return _coded_apply(shards[name], x2d, dec_w, metas[name], wire=wire,
                            mats=mats.get((layer, name)),
                            force_kernel=force_kernel)

    proj = {}
    mla = desc.mixer == "mla"
    if "qkv" in metas and mla:                            # wq | w_dkv
        h, qk = cfg.n_heads_padded, cfg.qk_nope_head_dim + \
            cfg.qk_rope_head_dim

        def qkv(x):                                       # (B, 1, d)
            b = x.shape[0]
            y = run("qkv", x.reshape(b, -1)).to(cd)
            qw = metas["qkv"].split[0]
            return y[:, :qw].reshape(b, 1, h, qk), y[:, None, qw:]
        proj["qkv"] = qkv
    elif "qkv" in metas:
        hd, hq, kvh = cfg.head_dim_, cfg.n_heads_padded, cfg.n_kv_heads_padded

        def qkv(x):                                       # (B, 1, d)
            b = x.shape[0]
            y = run("qkv", x.reshape(b, -1)).to(cd)
            s0, s1, _ = metas["qkv"].split
            return (y[:, :s0].reshape(b, 1, hq, hd),
                    y[:, s0:s0 + s1].reshape(b, 1, kvh, hd),
                    y[:, s0 + s1:].reshape(b, 1, kvh, hd))
        proj["qkv"] = qkv
    if "o" in metas and mla:
        def o_fn(o2d):                                    # (B, H v) -> (B, d)
            return run("o", o2d).to(cd)
        proj["o"] = o_fn
    elif "o" in metas:
        def o_fn(out):                                    # (B,1,f) -> (B,1,d)
            b = out.shape[0]
            return run("o", out.reshape(b, -1)).to(cd)[:, None, :]
        proj["o"] = o_fn
    if "up" in metas:
        if cfg.activation == "swiglu":
            def up_fn(x):                                 # -> (gate, up)
                b = x.shape[0]
                y = run("up", x.reshape(b, -1)).to(cd)
                ff = metas["up"].split[0]
                return y[:, None, :ff], y[:, None, ff:]
        else:
            def up_fn(x):
                b = x.shape[0]
                return run("up", x.reshape(b, -1)).to(cd)[:, None, :]
        proj["up"] = up_fn
    if "down" in metas:
        def down_fn(h):                                   # (B,1,ff) -> (B,1,d)
            b = h.shape[0]
            return run("down", h.reshape(b, -1)).to(cd)[:, None, :]
        proj["down"] = down_fn
    return proj


def coded_step_logits(model, scheme, code: ServingCode, cache, tokens, pos,
                      mask, *, wire=None, materials=None,
                      force_kernel=None):
    """The step up to its logits: embed → every layer with its projections
    routed through coded sites → coded unembed.  ``tokens`` (B, 1),
    ``pos`` (B,) per-slot positions, ``mask`` (N,) the step's responder
    mask.  Returns (logits (B, V), cache), the cache written in place."""
    cfg = model.cfg
    dec_w = scheme.decode_matrix_masked(mask).to(
        device=tokens.device, dtype=torch.float32)           # (K, N)
    x = embed(model.embedding, tokens, cfg)
    for i, layer in enumerate(model.layers):
        proj = _layer_proj(cfg, layer.desc, code.layer_meta[i],
                           code.layer_shards[i], dec_w, wire=wire,
                           mats=materials, layer=i,
                           force_kernel=force_kernel)
        x, cache[i] = layer.decode(x, cache[i], pos, proj=proj)
    x = apply_norm(model.final_norm, x, cfg)
    if code.unembed_meta is not None:
        logits = _coded_apply(code.unembed_shards, x[:, 0, :], dec_w,
                              code.unembed_meta, wire=wire,
                              mats=(materials or {}).get((None, "unembed")),
                              force_kernel=force_kernel)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
    else:
        logits = unembed(model.embedding, x, cfg)[:, 0, :]
    return logits, cache


def build_coded_step(model, scheme, code: ServingCode, *, wire_params=None):
    """The whole-step function: ``step(cache, tokens (B, 1), pos (B,),
    mask (N,), materials) -> (next_tokens (B,) int32, cache)``, greedy
    argmax over :func:`coded_step_logits`.  ``step.logits`` is the same
    call without the argmax.  ``wire_params`` = (q, cipher_mode) puts every
    site's two transfers on the MEA-ECC wire."""
    force_kernel = scheme.use_kernel
    wire = None
    if wire_params is not None:
        from ..kernels.encrypted_round import wire_roundtrip
        q, mode = wire_params

        def wire(payload, mat):
            return wire_roundtrip(
                payload, mat, q=q, mode=mode,
                use_kernel=ops._use_kernel(payload, force_kernel))

    def logits(cache, tokens, pos, mask, materials=None):
        with torch.no_grad():
            return coded_step_logits(model, scheme, code, cache, tokens, pos,
                                     mask, wire=wire, materials=materials,
                                     force_kernel=force_kernel)

    def step(cache, tokens, pos, mask, materials=None):
        out, cache = logits(cache, tokens, pos, mask, materials)
        return out.argmax(dim=-1).to(torch.int32), cache

    step.logits = logits
    return step


# --------------------------------------------------------------------------
# analytic coded FLOP fraction
# --------------------------------------------------------------------------

def coded_flop_fraction(cfg: ModelConfig, coded_layers: str = "all",
                        ctx_len: int = 2048) -> float:
    """Coded fraction of one decode step's matmul FLOPs, analytic from the
    model config.

    Counts every per-token matmul: projections, attention score/value
    contractions at ``ctx_len`` cached tokens, FFN, unembed.  MoE and SSM
    mixers are uncoded (coarse FLOP estimates — they only widen the
    denominator); the common factor 2 (multiply-add) cancels.  Config
    arithmetic only, so it covers every family, ported or not.
    """
    if coded_layers == "none":
        return 0.0
    want_attn = coded_layers in ("attn", "all")
    want_ffn = coded_layers in ("ffn", "all")
    d = cfg.d_model
    coded = total = 0.0
    for idx in range(cfg.n_layers):
        desc = layer_desc(cfg, idx)
        if desc.mixer == "attn":
            hd, hq = cfg.head_dim_, cfg.n_heads_padded
            kv = cfg.n_kv_heads_padded
            proj = d * (hq + 2 * kv) * hd + hq * hd * d
            total += proj + 2 * ctx_len * hq * hd          # scores + values
            if want_attn:
                coded += proj
        elif desc.mixer == "mla":
            h = cfg.n_heads_padded
            nope, rp = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            lora, vh = cfg.kv_lora_rank, cfg.v_head_dim
            site = d * h * (nope + rp) + d * (lora + rp) + h * vh * d
            latent = (h * nope * lora + h * ctx_len * (lora + rp)
                      + h * ctx_len * lora + h * lora * vh)
            total += site + latent
            if want_attn:
                coded += site
        elif desc.mixer == "mamba":
            e = cfg.expand
            total += 3 * e * d * d + e * d * 3 * cfg.d_state
        elif desc.mixer == "rwkv":
            total += 8 * d * d
        if desc.ffn == "dense":
            f = (3 if cfg.activation == "swiglu" else 2) * d * cfg.d_ff
            total += f
            if want_ffn:
                coded += f
        elif desc.ffn == "moe":
            experts = cfg.top_k + (cfg.n_shared_experts or 0)
            total += (experts * 3 * d * cfg.moe_d_ff + d * cfg.n_experts)
    unemb = d * cfg.vocab_size
    total += unemb
    coded += unemb
    return coded / total
