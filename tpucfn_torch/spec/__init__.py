"""Cluster specification: the machines a job runs on."""

from tpucfn_torch.spec.cluster import (ACCELERATOR_TYPES, AcceleratorType,
                                       ClusterSpec)

__all__ = ["ACCELERATOR_TYPES", "AcceleratorType", "ClusterSpec"]
