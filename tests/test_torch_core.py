"""The port's KND core against the JAX package's, on the CPU.

The same inputs go through both packages' copies of the control-plane
core: the CEL evaluator on every expression of ``tests/test_cel.py`` and
``tests/test_cel_cache.py`` (the same value, or a ``CelError`` with the
same message), driver discovery on the paper's a4 testbed and on TPU
pods (the same slices, devices, attributes and capacities), the
structured allocator on randomized inventories and claims and on
``MatchAttribute`` claims (the same allocations, the same failures),
the mesh planner (the same chip grid, dilation and link class, aligned
and unaligned, at several grids and seeds) and the mesh runtime's rank
order (JAX's device order for the same attachment). Then the port's
``MeshRuntime.execute`` on a process group: it refuses without one and
with the wrong world size, and builds a ``DeviceMesh`` otherwise.
Everything is exact: no tolerance.
"""

import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.attributes as jattrs  # noqa: E402
import repro.core.cel as jcel  # noqa: E402
import repro.core.oci as joci  # noqa: E402
import repro.topology.gcp as jgcp  # noqa: E402
import repro.topology.tpu as jtpu  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.attributes as tattrs  # noqa: E402
import repro_torch.core.cel as tcel  # noqa: E402
import repro_torch.topology.gcp as tgcp  # noqa: E402
import repro_torch.topology.tpu as ttpu  # noqa: E402

SIDES = {
    "jax": types.SimpleNamespace(core=jcore, attrs=jattrs, cel=jcel, tpu=jtpu, gcp=jgcp),
    "torch": types.SimpleNamespace(core=tcore, attrs=tattrs, cel=tcel, tpu=ttpu, gcp=tgcp),
}


# ---------------------------------------------------------------------------
# CEL
# ---------------------------------------------------------------------------

def device_env(side):
    a = side.attrs
    return {"device": {
        "attributes": a.AttributeSet.of({
            "repro.dev/pciRoot": "pci0000:85",
            "repro.dev/numa": 1,
            "repro.dev/rdma": True,
            "repro.dev/driverVersion": a.Version.parse("2.3.1"),
        }),
        "capacity": {"hbm": a.Quantity.parse("16Gi"),
                     "bandwidth": a.Quantity.parse("50G")},
    }}


ENVS = {
    "device": device_env,
    "none": lambda side: {},
    "ab1": lambda side: {"a": 1, "b": 2},
    "ab2": lambda side: {"a": -3, "b": 10},
    "ab3": lambda side: {"a": 0, "b": 0},
    "k2": lambda side: {"k": 2},
    "k10": lambda side: {"k": 10},
}

# (expression, environment, as a selector): every expression of
# tests/test_cel.py and tests/test_cel_cache.py, the property tests'
# at fixed samples
CEL_CASES = [
    ('device.attributes["repro.dev/rdma"]', "device", False),
    ("device.attributes.rdma", "device", False),
    ('device.attributes.pciRoot.startsWith("pci0000")', "device", False),
    ('device.capacity["hbm"] >= "8Gi"', "device", False),
    ('device.capacity["hbm"] >= "32Gi"', "device", False),
    ('device.attributes.driverVersion >= semver("2.0")', "device", False),
    ("has(device.attributes.rdma)", "device", False),
    ("has(device.attributes.nonexistent)", "device", False),
    ("[1,2,3].exists(x, x > 2)", "none", False),
    ("[1,2,3].all(x, x > 0)", "none", False),
    ("[1,2,3,4].filter(x, x % 2 == 0)", "none", False),
    ("[1,2].map(x, x * 10)", "none", False),
    ('device.attributes.numa == 1 ? "a" : "b"', "device", False),
    ("false || true", "none", False),
    ("false && true", "none", False),
    ("true || undefined_var > 1", "none", False),
    ("false && undefined_var > 1", "none", False),
    ("1 + 2 * 3", "none", False),
    ("(1 + 2) * 3", "none", False),
    ("7 / 2", "none", False),
    ("7.0 / 2", "none", False),
    ('"roce" in ["rdma", "roce"]', "none", False),
    ("5 in [1, 2]", "none", False),
    ('size("abc") == 3', "none", False),
    ('"gpu0rdma0".matches("gpu[0-9]+rdma[0-9]+")', "none", False),
    ('"abc".contains("b")', "none", False),
    ('"abc".endsWith("bc")', "none", False),
    ("device.nope", "device", False),
    ("1 +", "device", False),
    ("foo()", "device", False),
    ('"a" && true', "device", False),
    ("[1,2", "device", False),
    ("a.b.(", "device", False),
    ("1 ? 2 : ", "device", False),
    ("exists(x)", "device", False),
    ("1 + 1", "none", True),
    ("-7 < 12", "none", False),
    ("1000000 == 1000000", "none", False),
    ("size([])", "none", False),
    ("size([3, 1, 4, 1, 5])", "none", False),
    ("[-5, 0, 7].exists(v, v > 6)", "none", False),
    ("[-5, 0, 7].exists(v, v > 7)", "none", False),
    ('"aX0z" == "aX0z"', "none", False),
    ('device.attributes["rdma"] == true', "device", True),
    ("a + b * 2", "ab1", False),
    ("a + b * 2", "ab2", False),
    ("a + b * 2", "ab3", False),
    ("1+1", "none", False),
    ("[1, 2, 3].map(v, v * k)", "k2", False),
    ("[1, 2, 3].map(v, v * k)", "k10", False),
]


def cel_outcome(side, expr, env, selector):
    try:
        if selector:
            return ("value", side.cel.compile_expr(expr).evaluate_bool(ENVS[env](side)))
        return ("value", side.cel.evaluate(expr, ENVS[env](side)))
    except side.cel.CelError as e:
        return ("CelError", str(e))


@pytest.mark.parametrize("expr,env,selector", CEL_CASES)
def test_cel_matches_jax(expr, env, selector):
    got = cel_outcome(SIDES["torch"], expr, env, selector)
    want = cel_outcome(SIDES["jax"], expr, env, selector)
    assert got == want
    assert type(got[1]) is type(want[1])


# ---------------------------------------------------------------------------
# Discovery
# ---------------------------------------------------------------------------

def slices_of(pool):
    """Every published slice as plain data, in publication order."""
    return [(sl.driver, sl.pool, sl.node,
             [(d.name, d.id, d.node, sorted((k, repr(v)) for k, v in d.attributes.items()),
               sorted((k, float(q)) for k, q in d.capacity.items())) for d in sl])
            for sl in pool.slices]


def a4_registry(side, nodes=2):
    fab, _ = side.gcp.build_a4_cluster(nodes)
    reg = side.core.DriverRegistry()
    reg.add(side.core.GpuDriver(fab)).add(side.core.NicDriver(fab))
    return reg


def tpu_registry(side, pods, x, y):
    cluster = side.tpu.build_tpu_cluster(pods, side.tpu.TpuPodSpec(x=x, y=y))
    reg = side.core.DriverRegistry()
    reg.add(side.core.TpuDriver(cluster)).add(side.core.IciDriver(cluster))
    return cluster, reg


@pytest.mark.parametrize("world", ["a4-1", "a4-2", "tpu-1x4x4", "tpu-2x4x2", "tpu-1x16x16"])
def test_discovery_matches_jax(world):
    out = {}
    for name, side in SIDES.items():
        if world.startswith("a4"):
            reg = a4_registry(side, int(world[-1]))
        else:
            pods, x, y = (int(v) for v in world[4:].split("x"))
            _, reg = tpu_registry(side, pods, x, y)
        n = reg.run_discovery()
        again = reg.run_discovery()          # incremental: nothing moved
        classes = sorted((c.name, tuple(c.selectors)) for c in reg.classes.values())
        out[name] = (n, again, classes, slices_of(reg.pool))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] > 0 and out["torch"][1] == 0


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

RACKS = ("r0", "r1", "r2")
MODELS = ("m-a", "m-b")


def random_world(side, rng, n_claims):
    """tests/conftest.py's randomized inventory and claims, built from one
    package's types (the same draws on both sides)."""
    c = side.core
    pool = c.ResourcePool()
    for n in range(rng.randint(2, 5)):
        sl = c.ResourceSlice(driver="drv", pool=f"p{n % 2}", node=f"node-{n}")
        for i in range(rng.randint(2, 7)):
            attrs = {"drv/rack": rng.choice(RACKS), "drv/model": rng.choice(MODELS),
                     "drv/index": i}
            if rng.random() < 0.8:
                attrs["drv/pciRoot"] = f"pci{rng.randint(0, 2)}"
            sl.add(c.Device(name=f"d{n}-{i}", attributes=c.AttributeSet.of(attrs)))
        pool.publish(sl)
    classes = {
        "any": c.DeviceClass("any", selectors=['device.driver == "drv"']),
        "model-a": c.DeviceClass("model-a", selectors=['device.attributes["model"] == "m-a"']),
    }
    claims = []
    for ci in range(n_claims):
        reqs = []
        for r in range(rng.randint(1, 2)):
            sel = []
            if rng.random() < 0.4:
                sel.append(f'device.attributes["index"] >= {rng.randint(0, 2)}')
            reqs.append(c.DeviceRequest(name=f"req{r}",
                                        device_class=rng.choice(["any", "model-a"]),
                                        selectors=sel, count=rng.randint(1, 3)))
        constraints = []
        if rng.random() < 0.5:
            constraints.append(c.MatchAttribute(
                attribute=rng.choice(["rack", "pciRoot"]),
                requests=[r.name for r in reqs if rng.random() < 0.8]))
        claims.append(c.ResourceClaim(name=f"claim-{ci}", spec=c.ClaimSpec(
            requests=reqs, constraints=constraints,
            topology_scope=rng.choice(["node", "cluster"]))))
    return pool, classes, claims


def allocate_all(side, alloc, claims, rng=None):
    """Each claim's outcome: the node and (request, device id) pairs, or
    the error's message; some claims freed again when ``rng`` is given."""
    out = []
    for claim in claims:
        try:
            res = alloc.allocate(claim)
            out.append(("ok", res.node, tuple((a.request, a.ref.id) for a in res.devices)))
        except side.core.AllocationError as e:
            out.append(("err", str(e)))
        if rng is not None and rng.random() < 0.3 and claim.allocated:
            alloc.deallocate(claim)
            out.append(("freed", claim.name))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_structured_allocator_matches_jax_random(seed):
    out = {}
    for name, side in SIDES.items():
        rng = random.Random(seed)
        pool, classes, claims = random_world(side, rng, 8)
        out[name] = allocate_all(side, side.core.StructuredAllocator(pool, classes),
                                 claims, rng)
    assert out["torch"] == out["jax"]
    assert any(o[0] == "ok" for o in out["torch"])


def a4_claims(side):
    """GPU + RDMA NIC pairs on one PCI root (the paper's aligned claim),
    a cluster-wide GPU claim, and claims no inventory satisfies."""
    c = side.core

    def pair(name, gpus, constrained=True, scope="node"):
        reqs = [c.DeviceRequest(name="gpu", device_class="gpu.nvidia.com", count=gpus),
                c.DeviceRequest(name="nic", device_class="rdma-nic", count=gpus)]
        cons = [c.MatchAttribute(attribute="pciRoot", requests=["gpu", "nic"])] \
            if constrained else []
        return c.ResourceClaim(name=name, spec=c.ClaimSpec(
            requests=reqs, constraints=cons, topology_scope=scope))

    def gpus(name, n, scope, selectors=()):
        return c.ResourceClaim(name=name, spec=c.ClaimSpec(requests=[c.DeviceRequest(
            name="gpu", device_class="gpu.nvidia.com", count=n,
            selectors=list(selectors))], topology_scope=scope))

    return [pair("aligned-1", 1), pair("aligned-2", 1), pair("aligned-pair", 2),
            pair("free-pair", 1, constrained=False),
            gpus("socket1", 2, "node", ['device.attributes["socket"] == 1']),
            gpus("cluster-4", 4, "cluster"),
            gpus("too-many", 9, "node"), pair("too-many-pairs", 9),
            gpus("no-model", 1, "node", ['device.attributes["model"] == "H100"']),
            gpus("rest", 3, "cluster")]


def test_structured_allocator_matches_jax_a4():
    out = {}
    for name, side in SIDES.items():
        reg = a4_registry(side)
        reg.run_discovery()
        alloc = side.core.StructuredAllocator(reg.pool, reg.classes)
        out[name] = allocate_all(side, alloc, a4_claims(side))
    assert out["torch"] == out["jax"]
    # one GPU and one NIC per PCI root: two aligned pairs cannot share
    # one, and nine GPUs, nine pairs and an H100 exceed the inventory
    assert [o[1].split(":")[0] for o in out["torch"] if o[0] == "err"] == [
        "claim aligned-pair", "claim too-many", "claim too-many-pairs", "claim no-model"]


@pytest.mark.parametrize("chips", [1, 4, 16, 17])
def test_planner_claims_allocate_as_jax(chips):
    out = {}
    for name, side in SIDES.items():
        cluster, reg = tpu_registry(side, 1, 4, 4)
        reg.run_discovery()
        claim = side.core.MeshPlanner(cluster).make_claim("chips", chips)
        out[name] = allocate_all(side, side.core.StructuredAllocator(reg.pool, reg.classes),
                                 [claim])
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0] == ("err" if chips > 16 else "ok")


# ---------------------------------------------------------------------------
# Planning and the runtime's rank order
# ---------------------------------------------------------------------------

PLANS = {
    "16x16": (1, 16, 16, [("data", 16, "y"), ("model", 16, "x")]),
    "4x8": (1, 16, 16, [("data", 4, "y"), ("model", 8, "x")]),
    "pod-2x4x4": (2, 16, 16, [("pod", 2, "pod"), ("data", 4, "y"), ("model", 4, "x")]),
    "shared-y": (1, 16, 16, [("data", 2, "y"), ("fsdp", 4, "y"), ("model", 16, "x")]),
    "4x2": (1, 4, 2, [("data", 2, "y"), ("model", 4, "x")]),
    "3x5": (1, 8, 8, [("data", 3, "y"), ("model", 5, "x")]),
    "1x1": (1, 1, 1, [("data", 1, "y"), ("model", 1, "x")]),
}


def plan_of(side, key, placement, seed):
    pods, x, y, axes = PLANS[key]
    cluster = side.tpu.build_tpu_cluster(pods, side.tpu.TpuPodSpec(x=x, y=y))
    plan = side.core.MeshPlanner(cluster).plan(
        [side.core.AxisSpec(*a) for a in axes], placement, seed=seed)
    return plan


@pytest.mark.parametrize("key", sorted(PLANS))
@pytest.mark.parametrize("placement,seed", [("aligned", 0), ("unaligned", 0),
                                            ("unaligned", 7)])
def test_planner_matches_jax(key, placement, seed):
    got, want = (plan_of(SIDES[s], key, placement, seed) for s in ("torch", "jax"))
    assert got.axis_names == want.axis_names and got.axis_shape == want.axis_shape
    assert got.chip_grid.tolist() == want.chip_grid.tolist()
    assert got.dilation == want.dilation
    assert got.link_class == want.link_class
    assert got.summary() == want.summary()


@pytest.mark.parametrize("key", sorted(PLANS))
def test_runtime_rank_order_matches_jax_device_order(key, monkeypatch):
    """The port's rank at each mesh coordinate is the index of the device
    JAX's runtime puts there, for the same attachment: JAX's ``Mesh``
    is captured in place of building it, over devices 0..n-1."""
    attach_t = plan_of(SIDES["torch"], key, "unaligned", 3).attachment()
    attach_j = plan_of(SIDES["jax"], key, "unaligned", 3).attachment()
    # the bindings arrive shuffled: the order is the runtime's to make
    random.Random(1).shuffle(attach_t.bindings)
    random.Random(1).shuffle(attach_j.bindings)
    monkeypatch.setattr(jax.sharding, "Mesh", lambda arr, names, **kw: (arr, names))
    arr, names = joci.MeshRuntime().execute(attach_j, jax_devices=list(range(len(
        attach_j.bindings))))
    grid = tcore.MeshRuntime.rank_grid(attach_t)
    assert names == attach_t.axis_names
    assert grid.tolist() == arr.astype(np.int64).tolist()


@pytest.fixture
def gloo_world_1(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_runtime_refuses_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    spec = plan_of(SIDES["torch"], "1x1", "aligned", 0).attachment()
    with pytest.raises(RuntimeError, match="no process group"):
        tcore.MeshRuntime("cpu").execute(spec)


def test_runtime_builds_the_mesh_of_its_world(gloo_world_1):
    runtime = tcore.MeshRuntime("cpu")
    big = plan_of(SIDES["torch"], "4x2", "aligned", 0).attachment()
    with pytest.raises(RuntimeError, match="8 devices, the process group has 1"):
        runtime.execute(big)
    spec = plan_of(SIDES["torch"], "1x1", "aligned", 0).attachment()
    mesh = runtime.execute(spec)
    assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("data", "model")
    assert mesh.mesh.tolist() == [[0]]
    assert runtime.executed == (spec,)
    bad = tcore.AttachmentSpec(("data",), (2,), [tcore.DeviceBinding("a", (0,)),
                                                 tcore.DeviceBinding("b", (0,))])
    with pytest.raises(ValueError, match="duplicate"):
        runtime.execute(bad)


def test_knd_workflow_end_to_end(gloo_world_1):
    """Discovery -> claim -> allocation -> NRI prepare and sandbox hooks
    -> plan -> attachment -> mesh, as the JAX package's planner test
    runs it, with the ICI driver's KEP-4817 status on the claim."""
    cluster, reg = tpu_registry(SIDES["torch"], 1, 1, 1)
    reg.run_discovery()
    planner = tcore.MeshPlanner(cluster)
    claim = planner.make_claim("job", 1)
    tcore.StructuredAllocator(reg.pool, reg.classes).allocate(claim)
    prepared = reg.prepare(claim)
    assert set(prepared) == {"tpu.google.com"} and claim.prepared
    plan = planner.plan([tcore.AxisSpec("data", 1, "y"), tcore.AxisSpec("model", 1, "x")],
                        "aligned", claim)
    hooks = reg.bus.publish(tcore.Events.RUN_POD_SANDBOX, plan=plan, claim=claim)
    specs = [h.value for h in hooks if h.driver == "dranet.repro.dev"]
    assert len(specs) == 1 and specs[0].axis_shape == (1, 1)
    assert claim.allocation.device_statuses
    mesh = tcore.MeshRuntime("cpu").execute(specs[0])
    assert mesh.mesh_dim_names == ("data", "model")
