"""Counterparts of ``protocol_tpu/parallel``: the provider mesh, the
sharded passes over it, and the solve arena."""

from protocol_tpu_torch.parallel.auction import assign_auction_sharded
from protocol_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple
from protocol_tpu_torch.parallel.sinkhorn import sinkhorn_potentials_sharded
from protocol_tpu_torch.parallel.sparse import (
    assign_auction_sparse_scaled_sharded,
    assign_auction_sparse_sharded,
    assign_auction_sparse_warm_sharded,
    candidates_topk_bidir_sharded,
)
from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena

__all__ = [
    "TorchSolveArena",
    "assign_auction_sharded",
    "assign_auction_sparse_scaled_sharded",
    "assign_auction_sparse_sharded",
    "assign_auction_sparse_warm_sharded",
    "candidates_topk_bidir_sharded",
    "make_mesh",
    "pad_to_multiple",
    "sinkhorn_potentials_sharded",
]
