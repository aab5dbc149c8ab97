"""Production meshes + the KND-planned mesh path.

``make_planned_mesh`` / ``planned_mesh_for`` are the KND path: discovery
-> claim -> allocation -> plan -> OCI attachment, all as ControlPlane
object submissions; they return the torch ``DeviceMesh`` *plus* the
MeshPlan carrying placement dilation metadata. ``make_production_mesh``
keeps the raw ``init_device_mesh`` construction as the reference arm.

The port of the JAX package's ``launch/mesh.py``: where that module
builds a ``jax.sharding.Mesh``, this one builds a ``DeviceMesh`` over
the initialised process group (one rank per chip of the plan), so every
mesh needs a group of the mesh's size. ``build_mesh=False`` plans
without one.

NOTE: importing this module touches no process group; all meshes are
built inside functions.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["make_production_mesh", "make_planned_mesh", "planned_mesh_for",
           "mesh_axis_specs"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh straight over the process group (no KND)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=axes)


def mesh_axis_specs(multi_pod: bool = False):
    """AxisSpec list for the planner matching the production mesh."""
    from ..core.planner import AxisSpec
    if multi_pod:
        return [AxisSpec("pod", 2, "pod"), AxisSpec("data", 16, "y"),
                AxisSpec("model", 16, "x")]
    return [AxisSpec("data", 16, "y"), AxisSpec("model", 16, "x")]


def make_planned_mesh(*, multi_pod: bool = False, placement: str = "aligned",
                      seed: int = 0, device_type: str = "cuda"):
    """Full KND workflow, declaratively -> (DeviceMesh, MeshPlan).

    Submits a ResourceClaim + Workload to the API store; the control
    plane's reconcilers run allocation, NodePrepareResources, the NRI
    hooks and the OCI attachment, and the mesh is read off the
    workload's status once its ``Ready`` condition is True.
    """
    from .. import core
    from ..api import ControlPlane, Workload
    from ..topology.tpu import build_tpu_cluster

    num_pods = 2 if multi_pod else 1
    cluster = build_tpu_cluster(num_pods=num_pods)
    reg = core.DriverRegistry()
    reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
    plane = ControlPlane(reg, cluster,
                         runtime=core.MeshRuntime(device_type))
    plane.run_discovery()

    n_chips = 512 if multi_pod else 256
    claim_name = f"mesh-{placement}"
    plane.submit(plane.planner.make_claim(claim_name, n_chips))
    plane.submit(Workload(claim=claim_name, axes=mesh_axis_specs(multi_pod),
                          placement=placement, seed=seed),
                 name=f"{claim_name}-job")
    obj = plane.wait_for("Workload", f"{claim_name}-job")
    return obj.status.outputs["mesh"], obj.status.outputs["plan"]


def planned_mesh_for(shape: Sequence[int], names: Sequence[str], *,
                     placement: str = "aligned", seed: int = 0,
                     build_mesh: bool = True,
                     device_type: str = "cuda"):
    """Arbitrary logical mesh via ControlPlane object submission.

    Packs the logical axes onto the pod torus (an axis named ``"pod"``
    maps to the DCN dimension; the rest split over the y then x torus
    dims, outer-to-inner), submits a ResourceClaim + Workload, and reads
    (mesh, plan) off the Ready workload's status (mesh None when
    ``build_mesh`` is False).
    """
    from .. import core
    from ..api import ControlPlane, Workload
    from ..topology.tpu import TpuPodSpec, build_tpu_cluster

    if len(shape) != len(names):
        raise ValueError(f"shape {shape} / names {names} length mismatch")
    pod_spec = TpuPodSpec()
    pairs = list(zip(names, shape))
    axes = []
    num_pods = 1
    if pairs and pairs[0][0] == "pod":
        name, size = pairs.pop(0)
        num_pods = size
        axes.append(core.AxisSpec(name, size, "pod"))
    per_pod = math.prod(s for _, s in pairs)
    if per_pod > pod_spec.num_chips:
        raise ValueError(f"{per_pod} chips/pod > {pod_spec.num_chips}; "
                         f"lead with a 'pod' axis to span pods")
    # split the remaining axes into a y-hosted prefix and x-hosted suffix
    sizes = [s for _, s in pairs]
    split = None
    for k in range(len(pairs) + 1):
        if (math.prod(sizes[:k]) <= pod_spec.y
                and math.prod(sizes[k:]) <= pod_spec.x):
            split = k
            break
    if split is None:
        raise ValueError(f"axes {list(zip(names, shape))} do not pack onto "
                         f"a {pod_spec.x}x{pod_spec.y} torus")
    axes += [core.AxisSpec(n, s, "y") for n, s in pairs[:split]]
    axes += [core.AxisSpec(n, s, "x") for n, s in pairs[split:]]

    cluster = build_tpu_cluster(num_pods, pod_spec)
    reg = core.DriverRegistry()
    reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
    plane = ControlPlane(reg, cluster,
                         runtime=core.MeshRuntime(device_type))
    plane.run_discovery()
    claim_name = "mesh-" + "x".join(str(s) for s in shape)
    plane.submit(plane.planner.make_claim(claim_name, num_pods * per_pod))
    plane.submit(Workload(claim=claim_name, axes=axes, placement=placement,
                          seed=seed, build_mesh=build_mesh),
                 name=f"{claim_name}-job")
    obj = plane.wait_for("Workload", f"{claim_name}-job")
    return obj.status.outputs.get("mesh"), obj.status.outputs["plan"]
