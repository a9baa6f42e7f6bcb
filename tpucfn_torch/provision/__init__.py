"""The control plane and provisioner (copies of the JAX package's
``tpucfn/provision/{control_plane,provisioner,policy}.py``).  Only the
fake control plane is ported: ``provision/gcp.py`` drives TPU queued
resources, which a GPU host has no use for."""

from tpucfn_torch.provision.control_plane import (ClusterRecord, ClusterState,
                                                  ControlPlane,
                                                  FakeControlPlane,
                                                  HostRecord)
from tpucfn_torch.provision.policy import (PROVISION_DECISION_TABLE,
                                           FleetObservation, GoodputSignal,
                                           PolicyAction, PolicyConfig,
                                           PolicyDecision, ProvisionPolicy,
                                           provision_policy_from_name)
from tpucfn_torch.provision.provisioner import Provisioner

__all__ = ["PROVISION_DECISION_TABLE", "ClusterRecord", "ClusterState",
           "ControlPlane", "FakeControlPlane", "FleetObservation",
           "GoodputSignal", "HostRecord", "PolicyAction", "PolicyConfig",
           "PolicyDecision", "ProvisionPolicy", "Provisioner",
           "provision_policy_from_name"]
