"""Named-axis device meshes."""

from tpucfn_torch.mesh.mesh import (ALL_AXES, AXIS_CONTEXT, AXIS_DATA,
                                    AXIS_EXPERT, AXIS_FSDP, AXIS_PIPELINE,
                                    AXIS_TENSOR, BATCH_AXES, MeshSpec,
                                    build_mesh, local_mesh_devices,
                                    mesh_device, mesh_sizes)

__all__ = ["ALL_AXES", "AXIS_CONTEXT", "AXIS_DATA", "AXIS_EXPERT",
           "AXIS_FSDP", "AXIS_PIPELINE", "AXIS_TENSOR", "BATCH_AXES",
           "MeshSpec", "build_mesh", "local_mesh_devices", "mesh_device",
           "mesh_sizes"]
