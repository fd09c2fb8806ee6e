"""The distribution layer: gradient compression.

Ports ``repro/dist/compression.py``.  The reference's ``dist/sharding.py``
(PartitionSpec surgery and ``shard_hint`` over a device mesh) needs a
mesh of several devices (``torch.distributed``) and comes in a later
slice (see ROADMAP.md).
"""

from . import compression
from .compression import (int8_compress, int8_compress_shared,
                          int8_decompress)

__all__ = ["compression", "int8_compress", "int8_compress_shared",
           "int8_decompress"]
