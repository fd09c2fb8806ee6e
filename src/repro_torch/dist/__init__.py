"""The distribution layer: sharding-spec utilities, the mesh's counted
collectives, and gradient compression.

``sharding``     PartitionSpec surgery (pruning non-divisible dims, data-axis
                 insertion, specs -> DTensor placements), ``shard_hint``,
                 parameter placement (FSDP's too, and its gather) and the
                 dp axes' groups.  Ports ``repro/dist/sharding.py``.
                 (The sequence-sharded decode's attention is
                 ``models.attention._seq_sharded_attention``.)
``collectives``  the gloo collectives a mesh runs, in place and counted
                 (count, bytes; seconds when timed), and the probe of
                 which serve CUDA tensors.
``compression``  int8 symmetric quantization of gradient trees.  Ports
                 ``repro/dist/compression.py``.
"""

from . import collectives, compression, sharding
from .compression import (int8_compress, int8_compress_shared,
                          int8_decompress)
from .sharding import (P, add_data_axis, prune_spec, resolve_spec, shard_hint,
                       tree_add_data_axis, tree_shardings)

__all__ = ["collectives", "compression", "sharding", "int8_compress",
           "int8_compress_shared", "int8_decompress", "P", "add_data_axis",
           "prune_spec", "resolve_spec", "shard_hint", "tree_add_data_axis",
           "tree_shardings"]
