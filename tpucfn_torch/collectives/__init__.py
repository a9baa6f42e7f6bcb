"""Named-axis collectives over the mesh's process groups."""

from tpucfn_torch.collectives.ops import (all_gather, all_to_all, axis_index,
                                          axis_size, pmax, pmean, psum,
                                          reduce_scatter, ring_permute)

__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size", "pmax",
           "pmean", "psum", "reduce_scatter", "ring_permute"]
