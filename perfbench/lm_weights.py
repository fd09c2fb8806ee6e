"""A dense decoder-only LM's weights, made by the benchmark from the seed.

Both sides get the same weights: the program's model has them copied
into its parameters, and the reference makes them again for itself.
They are drawn on the device in a few large calls, one per chunk (the
embeddings and the final norm, then every ``LAYERS_PER_CHUNK`` layers):
one ``torch.randn`` into a flat float32 buffer with a generator seeded
for that chunk, cut into the chunk's leaves and scaled in place.  So a
chunk can be made again alone (the change of the parameters over the
checked steps is read leaf by leaf against it).  Norm scales are 1.

Leaves are named and shaped as ``repro_torch``'s ``TransformerLM``
names its parameters; the distributions are the port's init: N(0,
1/fan_in) for every matrix (fan_in its first dim), N(0, 0.02^2) for the
embedding table.  Nothing here imports the program.
"""

from __future__ import annotations

import math

from perfbench.core import seed_of

LAYERS_PER_CHUNK = 8
_CHUNK_SEED = 100            # seed purpose of chunk c: _CHUNK_SEED + c


def chunk_specs(cfg: dict) -> list:
    """Per chunk, its leaves as (name, shape, scale); scale None is a norm
    scale of ones."""
    d, ff, v = (cfg["hidden_size"], cfg["intermediate_size"],
                cfg["vocab_size"])
    hq, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    inv = lambda n: 1.0 / math.sqrt(n)       # noqa: E731
    first = [("embedding.table", (v, d), 0.02)]
    if not cfg.get("tie_word_embeddings", False):
        first.append(("embedding.unembed", (d, v), inv(d)))
    first.append(("final_norm.scale", (d,), None))
    out = [first]
    n_layers = cfg["num_hidden_layers"]
    for c0 in range(0, n_layers, LAYERS_PER_CHUNK):
        chunk = []
        for i in range(c0, min(c0 + LAYERS_PER_CHUNK, n_layers)):
            p = f"layers.{i}."
            chunk += [(p + "norm1.scale", (d,), None),
                      (p + "mixer.wq", (d, hq, hd), inv(d)),
                      (p + "mixer.wk", (d, kv, hd), inv(d)),
                      (p + "mixer.wv", (d, kv, hd), inv(d)),
                      (p + "mixer.wo", (hq, hd, d), inv(hq)),
                      (p + "norm2.scale", (d,), None),
                      (p + "ffn.w_gate", (d, ff), inv(d)),
                      (p + "ffn.w_up", (d, ff), inv(d)),
                      (p + "ffn.w_down", (ff, d), inv(ff))]
        out.append(chunk)
    return out


def make_chunk(torch, specs: list, seed: int, index: int, device) -> dict:
    """Chunk ``index``'s leaves {name: float32 tensor} on ``device``: views
    into one drawn buffer (norm scales apart)."""
    drawn = [(n, s, k) for n, s, k in specs if k is not None]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, _CHUNK_SEED + index))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, scale in drawn:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    for name, shape, scale in specs:
        if scale is None:
            out[name] = torch.ones(shape, device=device)
    return out


def leaf_names(cfg: dict) -> list:
    return [n for chunk in chunk_specs(cfg) for n, _, _ in chunk]


def change_norms(torch, params: dict, cfg: dict, seed: int, device,
                 specs=None) -> dict:
    """Each leaf's norm of its change since the start, the start made
    again chunk by chunk: {name: 0-dim float32 tensor on ``device``},
    launched without a sync."""
    out = {}
    specs = chunk_specs(cfg) if specs is None else specs
    with torch.no_grad():
        for c, chunk in enumerate(specs):
            start = make_chunk(torch, chunk, seed, c, device)
            for name, p0 in start.items():
                out[name] = torch.linalg.vector_norm(
                    params[name].detach().to(torch.float32) - p0)
            del start
    return out
