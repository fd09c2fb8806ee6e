"""Tile-size selection: the port's copy of ``repro/kernels/tiling.py``.

The invariant both helpers protect is that *tiling never forces more
padding than the alignment itself*: a dim just past a tile cap shrinks
the tile to a divisor, it does not round the payload up to ~2x.

No launcher in ``kernels/*.py`` pads a dim to a tile: the CUDA sources
choose their tiles and pad inside the C side (``coded_matmul_scratch``,
``flash_attention_scratch`` and ``flash_attention_bwd_scratch`` return the
padded extents the Python wrappers allocate), so nothing in the port
calls these yet.  They are kept, held to the reference's functions by
``tests/test_torch_dryrun.py``, for a launcher that comes to tile in
Python.
"""

from __future__ import annotations

__all__ = ["pad_to", "tile"]


def pad_to(x: int, m: int) -> int:
    """x rounded up to the next multiple of m."""
    return ((x + m - 1) // m) * m


def tile(dim: int, align: int, cap: int) -> tuple:
    """(tile, padded_dim): pad ``dim`` to its minimal alignment, then pick
    the largest tile <= cap that divides the padded dim exactly.  ``align``
    always divides the padded dim, so the worst case is a tile of
    ``align``, never extra payload padding."""
    padded = pad_to(dim, align)
    if padded <= cap:
        return padded, padded
    best = max(t for t in range(align, cap + 1, align) if padded % t == 0)
    return best, padded
