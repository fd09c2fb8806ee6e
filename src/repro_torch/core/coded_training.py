"""SPACDC applied to distributed training: the paper's SPACDC-DL (§VI) and
Berrut approximate gradient coding.

Ports ``repro/core/coded_training.py``:

1. ``coded_backprop_encode`` / ``coded_backprop_decode``: the layer-weight
   matrix Θ^l is split into K row-blocks, Berrut-encoded with T noise
   blocks, and N workers compute the backward product
   f_δ(Θ̃) = Θ̃^T δ^{l+1} ⊙ σ'(τ^l) on coded blocks; the master decodes
   δ^l ≈ ℵ(ξ_i) from whichever workers respond.
2. ``BerrutGradientCode`` (registered as ``berrut_grad``): approximate
   gradient coding over the data-parallel axis.  Shard i combines the
   gradients of the ``redundancy`` microbatch blocks cyclically assigned to
   it with its row of a masked, renormalized Berrut encoder; the mean
   gradient decodes from any survivor set.  The coding matrices are host
   numpy, the decode weights and the per-shard combination tensors.

3. ``coded_psum``: the coded all-reduce over a mesh axis.  The reference's
   is a ``psum`` inside ``shard_map``; the port's scales this rank's
   gradient by its decode weight and all-reduces it over the named mesh
   dim's gloo group (``launch.mesh``, ``dist.collectives``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import registry

__all__ = ["coded_backprop_encode", "coded_backprop_decode",
           "BerrutGradientCode", "coded_psum"]


def coded_backprop_encode(code, theta_t: torch.Tensor,
                          noise=None) -> torch.Tensor:
    """Encode (Θ^l)^T row-blocks into N coded weight shards (Eq. 25).
    ``noise`` optionally supplies the T noise blocks (see
    ``SPACDCCode.encode``)."""
    return code.encode(theta_t, noise)


def coded_backprop_decode(code, partials: torch.Tensor, responders,
                          sigma_prime: torch.Tensor) -> torch.Tensor:
    """Decode worker partial products and apply the σ' Hadamard (Eq. 26).

    partials: (|F|, rows/K, batch) worker results Θ̃_i^T δ.
    sigma_prime: (rows, batch) activation derivative at layer l.
    Returns δ^l ≈ (Θ^l)^T δ^{l+1} ⊙ σ'(τ^l)  with shape (rows, batch).
    """
    decoded = code.decode(partials, responders)      # (K, rows/K, batch)
    rows = sigma_prime.shape[0]
    flat = decoded.reshape((-1,) + tuple(decoded.shape[2:]))[:rows]
    return flat * sigma_prime


@dataclasses.dataclass(frozen=True)
class BerrutGradientCode:
    """Berrut approximate gradient coding over ``n_shards`` dp workers.

    The global batch is viewed as ``n_blocks`` microbatch blocks.  Shard i
    is assigned blocks {i, i+1, ..., i+redundancy-1} (mod n_blocks) and
    emits  e_i = Σ_j  E[i, j] · g(D_j)  where E is the Berrut encoder matrix
    masked to the shard's assignment and renormalized.  The decoder
    approximates the mean gradient from any responder subset via the
    Berrut interpolant evaluated at the block nodes.

    redundancy=1, n_blocks=n_shards  ⇒ e_i = g(D_i) (plain DP); the decode
    then reduces to a survivor-renormalized mean.  redundancy>1 buys
    straggler resilience at redundancy× compute, the paper's N/K trade.
    """
    n_shards: int
    n_blocks: int
    redundancy: int = 1
    t_noise: int = 0
    noise_scale: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.redundancy <= self.n_blocks):
            raise ValueError("redundancy must be in [1, n_blocks]")

    @functools.cached_property
    def _code(self):
        """The underlying SPACDC node layout, via the scheme registry."""
        return registry.build("spacdc", n_workers=self.n_shards,
                              k_blocks=self.n_blocks,
                              t_colluding=self.t_noise,
                              noise_scale=self.noise_scale, seed=self.seed)

    @functools.cached_property
    def _assignment(self) -> np.ndarray:
        base = np.arange(self.n_shards)[:, None] * max(
            1, self.n_blocks // self.n_shards)
        return (base + np.arange(self.redundancy)[None, :]) % self.n_blocks

    def assignment(self) -> np.ndarray:
        """(n_shards, redundancy) block ids per shard (cyclic)."""
        return self._assignment

    @functools.cached_property
    def _encoder_matrix(self) -> np.ndarray:
        full = self._code.enc_matrix.numpy()[:, : self.n_blocks]  # (N, B)
        mask = np.zeros_like(full)
        asn = self.assignment()
        for i in range(self.n_shards):
            mask[i, asn[i]] = 1.0
        sparse = full * mask
        # renormalize rows to sum 1 so each shard emits an affine combo
        sparse /= np.maximum(np.abs(sparse.sum(axis=1, keepdims=True)),
                             1e-9) * \
            np.sign(sparse.sum(axis=1, keepdims=True) + 1e-12)
        return sparse

    def encoder_matrix(self) -> np.ndarray:
        """(n_shards, n_blocks) row-sparse Berrut encoder (support =
        assignment), float32."""
        return self._encoder_matrix

    def decoder_weights(self, mask) -> torch.Tensor:
        """(n_shards,) decode weights for the masked responder set: the
        mean over the B block nodes of ``decode_matrix_masked``."""
        return self._code.decode_matrix_masked(mask).mean(dim=0)

    def encode_local(self, block_grads: torch.Tensor,
                     shard_index: int) -> torch.Tensor:
        """Combine this shard's per-block gradients with its encoder row.

        block_grads: (redundancy, ...) gradients of the assigned blocks in
        assignment order; ``shard_index``: this shard's index."""
        i = int(shard_index)
        row = self.encoder_matrix()[i, self.assignment()[i]]      # (r,)
        w = torch.as_tensor(row, dtype=torch.float32,
                            device=block_grads.device)
        flat = block_grads.reshape(self.redundancy, -1).to(torch.float32)
        return torch.einsum("r,rf->f", w, flat).reshape(
            block_grads.shape[1:])


def coded_psum(encoded_grad, mask, gcode: BerrutGradientCode, axis_name):
    """Coded all-reduce: Berrut-decode the mean gradient over survivors.

    ``encoded_grad``: a tree (dicts, lists) of this rank's encoded gradient
    contribution, tensors or DTensors; ``mask``: the (n_shards,) responder
    mask, a runtime value.  This rank's index ``idx`` is its coordinate on
    the mesh dim ``axis_name`` of the mesh ``launch.mesh.use_mesh``
    installed; each leaf becomes ``g * decoder_weights(mask)[idx] *
    mask[idx]`` in float32, summed over that dim (an all-reduce over its
    group).  A DTensor leaf is reduced through its local shard and keeps
    its placements.  Returns the tree of reduced leaves."""
    from torch.distributed.tensor import DTensor
    from ..dist import collectives
    from ..dist.sharding import ambient_mesh
    from ..tree import tree_map
    mesh = ambient_mesh()
    if mesh is None:
        raise ValueError("coded_psum runs on a mesh: install one with "
                         "launch.mesh.use_mesh")
    axis = axis_name[0] if isinstance(axis_name, (tuple, list)) and \
        len(axis_name) == 1 else axis_name
    if not isinstance(axis, str):
        raise ValueError(f"coded_psum reduces over one mesh axis, got "
                         f"{axis_name!r}")
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    mask_t = torch.as_tensor(mask).to(torch.float32)
    coef = float(gcode.decoder_weights(mask_t)[idx]) * float(mask_t[idx])

    def one(g):
        local = g.to_local() if isinstance(g, DTensor) else g
        out = local.to(torch.float32) * coef
        collectives.all_reduce(out, "sum", group)
        if isinstance(g, DTensor):
            return DTensor.from_local(out, g.device_mesh, g.placements,
                                      run_check=False)
        return out

    return tree_map(one, encoded_grad)


# Gradient codes live in the same registry as the data/pair codes so launch
# configs can name them ("berrut_grad") instead of importing classes.
registry.register(
    "berrut_grad",
    lambda n_shards, n_blocks=None, redundancy=1, t_noise=0, noise_scale=0.0,
    seed=0: BerrutGradientCode(n_shards, n_blocks or n_shards, redundancy,
                               t_noise, noise_scale, seed))
