"""Closed loop of coded training steps of a dense decoder LM.

The program: ``repro_torch.models.build_model`` on the meta device, its
parameters made on the card and filled with the benchmark's weights
(``perfbench/lm_weights.py``), AdamW (``repro_torch.optim``) and
``launch.steps.build_train_step(model, opt, accum=, gcode=
BerrutGradientCode(blocks, blocks))``.  Each step gets a new global batch
of token ids drawn uniformly on the device from the seed (every row new)
and a responder mask with ``stragglers`` of the blocks left out, drawn
from the seed; the step's loss is read back (a sync) before the next
starts.

Set-up drives that one step object through its first step, which
warms every shape, and reads each leaf's norm of that step's gradient as
the optimizer took it (its first moment after one step over 1 - b1).
The window continues with the same object on the same feed; its first
``checked_steps`` - 1 steps are checked too.  Of the ``checked_steps``
steps the check compares each step's loss, and after the last of them
each leaf's norm of its change since the start (the start made again
chunk by chunk, launched inside the window without a sync and read back
once it has closed: ~50 ms of device work a run).  So the AdamW update
of a timed step is compared.  Once the window has closed and the
program's state is freed, the reference follows the same checked steps
from the same weights, batches and masks.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from perfbench import lm_weights, work
from perfbench.core import Check, seed_of

_TOKENS, _MASKS = 1, 2            # seed purposes
# the compared numbers' limits: see PERF.md §2 for the readings they were
# set from
LIMITS = {"loss_rel_gap": 1e-4, "grad_norm_gap": 1e-2,
          "param_change_gap": 1e-3}
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone and is left out of the change
NOUGHT_GRAD = 1e-3


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a dense configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim", 0), rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        activation="swiglu" if cfg["hidden_act"] == "silu" else "gelu",
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["compute_dtype"],
        remat=cfg["remat"])


class Driver:
    def __init__(self, cell):
        self.cell, self.torch = cell, cell.torch
        tr = cell.traffic
        self.seq, self.batch = tr["seq_len"], tr["global_batch"]
        self.blocks, self.accum = tr["coded_blocks"], tr["accum"]
        self.n_checked = int(tr["checked_steps"])
        self.steps = []                  # wall seconds of each window step
        self.failed = 0
        self.fed = []                    # the checked steps' (batch, mask)
        self.losses = []                 # and their losses
        self.change = None               # each leaf's change after them
        self._sound = None               # the float32 reference's readings

    # ---- the feed -------------------------------------------------------
    def _seed_feed(self) -> None:
        self.gen = self.torch.Generator(device=self.cell.device)
        self.gen.manual_seed(seed_of(self.cell.seed, _TOKENS))
        self.rng = np.random.default_rng(seed_of(self.cell.seed, _MASKS))

    def _feed(self):
        torch, tr = self.torch, self.cell.traffic
        ids = torch.randint(0, self.cell.config["vocab_size"],
                            (self.batch, self.seq + 1), generator=self.gen,
                            device=self.cell.device)
        mask = np.ones(self.blocks, np.float32)
        mask[self.rng.choice(self.blocks, tr["stragglers"],
                             replace=False)] = 0.0
        return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}, mask

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        torch, cell = self.torch, self.cell
        from repro_torch.core import BerrutGradientCode
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models import build_model
        from repro_torch.optim import adamw, warmup_cosine
        cfg, dev = cell.config, cell.device
        t = time.perf_counter()
        self._seed_feed()
        model = build_model(model_config(cfg), device="meta")
        model.to_empty(device=dev)
        params = dict(model.named_parameters())
        specs = lm_weights.chunk_specs(cfg)
        if sorted(params) != sorted(lm_weights.leaf_names(cfg)):
            raise ValueError("the model's parameters are not the weights "
                             "the benchmark makes")
        with torch.no_grad():
            for c, chunk in enumerate(specs):
                for name, w in lm_weights.make_chunk(torch, chunk, cell.seed,
                                                     c, dev).items():
                    params[name].copy_(w)
        self.specs = specs
        self.setup_parts = {"model_and_weights":
                            self._sync_clock() - t}
        o = cfg["optimizer"]
        opt = adamw(warmup_cosine(o["peak_lr"], o["warmup_steps"],
                                  o["total_steps"], o["final_frac"]),
                    b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"],
                    max_grad_norm=o["max_grad_norm"])
        self.model, self.params, self.state = model, params, opt.init(params)
        self.step_fn = build_train_step(
            model, opt, accum=self.accum,
            gcode=BerrutGradientCode(self.blocks, self.blocks))
        t = time.perf_counter()
        batch, mask = self._feed()
        self.params, self.state, m = self.step_fn(self.params, self.state,
                                                  batch, mask)
        self._record(batch, mask, float(m["loss"]))
        norms = torch.stack([torch.linalg.vector_norm(mu)
                             for mu in self.state.mu.values()])
        self.grad_norms = dict(zip(self.state.mu,
                                   (norms / (1 - o["b1"])).tolist()))
        self.setup_parts["first_step"] = self._sync_clock() - t

    def _sync_clock(self) -> float:
        if self.cell.device.type == "cuda":
            self.torch.cuda.synchronize()
        return time.perf_counter()

    def _record(self, batch, mask, loss: float) -> None:
        """Keep a checked step's feed and loss; after the last, launch the
        read of each leaf's change since the start (device tensors, read
        back once the window has closed)."""
        self.fed.append((batch, mask))
        self.losses.append(loss)
        if len(self.fed) == self.n_checked:
            self.change = lm_weights.change_norms(
                self.torch, self.params, self.cell.config, self.cell.seed,
                self.cell.device, self.specs)

    def window(self, seconds: float, tracer) -> None:
        span, torch = tracer.span, self.torch
        on_card = self.cell.device.type == "cuda"
        tracer.start()
        t0 = time.perf_counter_ns()
        end = t0 + int(seconds * 1e9)
        self.t0_ns = t_last = t0
        while t_last < end:
            ts = time.perf_counter_ns()
            with span("feed"):
                batch, mask = self._feed()
            with span("step_fn"):
                self.params, self.state, m = self.step_fn(
                    self.params, self.state, batch, mask)
            with span("loss.item"):
                loss = float(m["loss"])
                if on_card:
                    torch.cuda.synchronize()
            te = time.perf_counter_ns()
            if len(self.fed) < self.n_checked:
                with span("check"):
                    self._record(batch, mask, loss)
            if te > end:
                break
            if not math.isfinite(loss):
                self.failed += 1
            self.steps.append((te - ts) / 1e9)
            t_last = te
        self.t1_ns = t_last
        tracer.stop()
        if self.change is not None:
            self.change = dict(zip(self.change, torch.stack(
                list(self.change.values())).tolist()))

    def end_to_end(self) -> dict:
        wall = (self.t1_ns - self.t0_ns) / 1e9
        return {"train_tokens_per_s": self.tokens_per_step *
                len(self.steps) / wall}

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    @property
    def n_units(self) -> int:
        """Whole steps completed in the window."""
        return len(self.steps)

    def work(self) -> dict:
        """Model FLOPs of one step and the attention backward's work per
        call and calls per step, from the shapes."""
        cfg = self.cell.config
        hq, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg.get("head_dim") or cfg["hidden_size"] // hq
        elt = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        nbytes, flops = work.flash_bwd_work(1, self.seq, self.seq, hq, kv, hd,
                                            hd, True, elt)
        micro = self.batch // (self.blocks * self.accum)
        return {"step_model_flops": work.model_flops_train(cfg, self.seq,
                                                           self.batch),
                "flash_bwd_bytes": nbytes * micro,
                "flash_bwd_flops": flops * micro,
                "flash_bwd_calls": cfg["num_hidden_layers"] * self.blocks *
                self.accum,
                "compute_dtype": cfg["compute_dtype"]}

    def release(self) -> None:
        for p in self.params.values():
            p.grad = None
        del self.model, self.params, self.state, self.step_fn
        gc.collect()
        if self.cell.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # ---- the check -----------------------------------------------------
    def _follow(self, precision="float32", rows="all"):
        """The reference's (losses, first gradient norms, change norms)
        over the checked steps (the float32 one kept for the controls)."""
        sound = (precision, rows) == ("float32", "all")
        if sound and self._sound is not None:
            return self._sound
        ref_mod = self.cell.reference()
        ref = ref_mod.Trainer(self.cell.config, self.cell.seed,
                              self.cell.device, precision)
        losses = []
        for i, (batch, mask) in enumerate(self.fed):
            losses.append(ref.step(batch["tokens"], batch["targets"], mask,
                                   self.blocks, self.accum, rows))
            if i == 0:
                grads = ref.grad_norms()
        change = ref.change_norms()
        del ref
        gc.collect()
        if self.cell.device.type == "cuda":
            self.torch.cuda.empty_cache()
        if sound:
            self._sound = (losses, grads, change)
        return losses, grads, change

    def check(self):
        if self.change is None:         # the window never reached them
            return [Check("checked_steps", float(len(self.fed)),
                          self.n_checked - 1)], len(self.steps), 1
        ref_mod = self.cell.reference()
        losses, grads, change = self._follow()
        return self._compare(ref_mod, (self.losses, self.grad_norms,
                                       self.change),
                             (losses, grads, change)), len(self.steps), \
            self.failed

    def control(self, precision: str, rows: str = "all"):
        """The check's numbers with the reference in ``precision``, or on
        ``rows="half"`` of each step's micro-batches, in the program's
        place."""
        if not self.fed:
            self._seed_feed()
            self.fed = [self._feed() for _ in range(self.n_checked)]
        got = self._follow(precision, rows)
        want = self._follow()
        return self._compare(self.cell.reference(), got, want)

    def _compare(self, ref_mod, got, want):
        (p_losses, p_grads, p_change), (losses, grads, change) = got, want
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(p_losses, losses))
        grad_gap, self.worst_grad_leaf = ref_mod.norm_gap(p_grads, grads)
        med = float(np.median(list(grads.values())))
        moving = {n for n, g in grads.items() if g >= NOUGHT_GRAD * med}
        change_gap, self.worst_change_leaf = ref_mod.norm_gap(
            p_change, change, moving)
        return [Check("loss_rel_gap", loss_gap, LIMITS["loss_rel_gap"]),
                Check("grad_norm_gap", grad_gap, LIMITS["grad_norm_gap"]),
                Check("param_change_gap", change_gap,
                      LIMITS["param_change_gap"])]
