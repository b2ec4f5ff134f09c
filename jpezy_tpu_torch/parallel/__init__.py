"""Mesh-sharded codec on torch.distributed: a ('data', 'tile') mesh with
one rank per shard, the DC-carry collective, and per-rank placement
(counterpart of jpezy_tpu/parallel)."""
from .mesh import make_mesh  # noqa: F401
from .api import decode_sharded, encode_sharded  # noqa: F401
