"""Device mesh with named parallelism axes (the port of
``tpucfn/mesh/mesh.py``).

The same six axes in the same order,

    (pipeline, data, fsdp, expert, context, tensor)
     outermost  ......  innermost

and the same :class:`MeshSpec` (a copy held equal to the JAX package's by
``tests/test_torch_isolation.py``).  :func:`build_mesh` makes a
``torch.distributed.device_mesh.DeviceMesh`` of the spec's sizes over the
ranks of the process group (one rank per card), with the axis names as
its dimension names.  ``build_multislice_mesh`` is not ported.
"""

from __future__ import annotations

import dataclasses
import math

AXIS_PIPELINE = "pipeline"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_CONTEXT = "context"
AXIS_TENSOR = "tensor"

# Outermost→innermost. Tensor parallelism is the most latency/bandwidth
# sensitive (collectives inside every layer), so it gets the innermost —
# physically closest — ICI neighbors. Pipeline only ppermutes activations at
# stage boundaries, so it tolerates the outermost placement (DCN between
# slices in a multislice job).
ALL_AXES = (
    AXIS_PIPELINE,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_CONTEXT,
    AXIS_TENSOR,
)

# Axes over which the global batch is split. FSDP is "data parallelism with
# sharded state", so the batch dimension shards over both.  The expert axis
# is a batch axis too (the standard expert-parallel layout): outside MoE
# layers its devices do ordinary data-parallel work instead of replicating
# it, and inside MoE the per-device token shard is what the explicit
# all-to-all dispatch exchanges over ``expert`` (tpucfn/models/moe.py).
BATCH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape — the analogue of the reference's
    ``WorkerCount`` CFN parameter, generalized to six named axes.

    Any axis left at 1 is still present in the mesh so sharding rules can
    mention it unconditionally; XLA elides collectives over size-1 axes.
    """

    pipeline: int = 1
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    context: int = 1
    tensor: int = 1

    def __post_init__(self):
        for name in ALL_AXES:
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"mesh axis {name!r} must be a positive int, got {v!r}")

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, name) for name in ALL_AXES)

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def dp_size(self) -> int:
        """Total data-parallel degree (batch shards)."""
        return self.data * self.fsdp

    @classmethod
    def for_devices(cls, n: int, **overrides: int) -> "MeshSpec":
        """Fill the ``data`` axis with whatever devices the explicit axes
        leave over — the common "just do DP over everything" default that
        matches the reference's behavior of using every GPU in the fleet.
        """
        if "data" in overrides:
            raise ValueError("pass data= via the constructor, not for_devices")
        fixed = math.prod(overrides.values()) if overrides else 1
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by explicit axes product {fixed}")
        return cls(data=n // fixed, **overrides)

    def validate(self, n_devices: int) -> None:
        if self.num_devices != n_devices:
            raise ValueError(
                f"MeshSpec wants {self.num_devices} devices "
                f"({dict(zip(ALL_AXES, self.axis_sizes))}) but {n_devices} are available"
            )


def _default_group(device_type: str, n_devices: int) -> int:
    """The world size of the default process group, made here as a
    one-rank group (over an in-memory store) when the process joined none
    and the spec wants one device: a plain single-host run."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if n_devices != 1:
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs a process group of as "
            "many ranks; join one first (tpucfn_torch.launch."
            "initialize_runtime under the launcher's env contract)")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return 1


def build_mesh(spec: MeshSpec | None = None, *, device_type: str = "cuda"):
    """The six-axis ``DeviceMesh`` of ``spec`` over the process group's
    ranks (``spec=None``: every rank on the ``data`` axis).  Ranks are laid
    out row-major over the axis sizes, innermost axes over adjacent ranks,
    as the JAX package lays out device ids."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _default_group(device_type,
                       1 if spec is None else spec.num_devices)
    if spec is None:
        spec = MeshSpec.for_devices(n)
    spec.validate(n)
    return init_device_mesh(device_type, spec.axis_sizes,
                            mesh_dim_names=ALL_AXES)


def mesh_device(mesh):
    """This rank's device of ``mesh``: the current card, or the CPU."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def local_mesh_devices(mesh) -> list:
    """Devices of ``mesh`` attached to this process: its one device."""
    return [mesh_device(mesh)]
