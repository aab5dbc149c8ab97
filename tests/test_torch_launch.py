"""The port's launchers with the control-plane flags, against the JAX package's.

* Serve: ``--smoke --device cpu --claim-chips 2`` provisions the replica
  set through the declarative plane (threaded informer, node agents) and
  gives the JAX launcher's replica claims, ``knd`` keys and greedy sample
  on the same weights (the JAX launcher reads ``sys.argv`` and prints
  its JSON); the SLO snapshot lands in the workload's ``outputs["slo"]``.
  A second run on the same ``--state-dir`` with one more slot adopts the
  two recovered claims with byte-identical allocations and stamps one.
* Train: ``--mesh 2x2 --devices 4`` starts four gloo ranks (the launcher
  spawns them and joins them within its timeout); its plan summary is
  JAX's ``MeshPlan.summary()`` for the same claim and placement, and its
  losses are within 1e-4 relative of the port's run without a mesh. A
  second run on the same ``--state-dir`` (node agents on) adopts the
  claim on every rank with its allocation and plan unchanged.
  On the card the step attends through the flash kernel wherever it is
  built for the config's head dim. ``--mesh`` with a world size that
  does not fit it raises.
* ``launch/mesh.py``: ``planned_mesh_for`` plans JAX's plan and
  attachment for the same shapes (a pod axis and the expert mesh
  included), ``mesh_axis_specs`` are JAX's, and with a process group of
  the right size it builds the ``DeviceMesh`` (and refuses otherwise).
"""

import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.api import ControlPlane as JaxControlPlane, Workload as JaxWorkload  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.topology.tpu import TpuPodSpec, build_tpu_cluster  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import allocation_records, recover_store  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "h2o-danube-1.8b"


def last_json(text):
    """The JSON object a launcher prints last (indented)."""
    return json.loads(text[text.rindex("\n{") + 1:] if "\n{" in text else text[text.index("{"):])


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's launcher serves the weights the JAX launcher draws."""
    jp = jlm.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(lm, "init_params", lambda cfg, seed, device=None: tp)


SERVE = ["--smoke", "--claim-chips", "2", "--requests", "3", "--slots", "2",
         "--new-tokens", "4"]


def test_serve_launcher_claims_match_jax(jax_weights, capsys, monkeypatch, tmp_path):
    state = str(tmp_path / "state")
    mine = serve.main(SERVE + ["--device", "cpu", "--state-dir", state, "--node-plane"])
    out = capsys.readouterr().out
    assert "[knd] serve replica set Ready: 2 claims (2 chips each)" in out
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE)
    jax_serve.main()
    theirs = last_json(capsys.readouterr().out)

    assert mine["knd"]["replica_claims"] == theirs["knd"]["replica_claims"]
    assert len(mine["knd"]["replica_claims"]) == 2
    assert set(mine["knd"]) == set(theirs["knd"])
    assert mine["knd"]["informer"]["reconciled"] > 0
    assert list(mine["dispatch"]) == mine["knd"]["replica_claims"][:1]
    assert mine["sample"] == theirs["sample"] and len(mine["sample"]) == 4
    assert mine["completed"] == theirs["completed"] == 3

    store, _ = recover_store(state)
    slo = store.get("Workload", "serve").status.outputs["slo"]
    assert slo["baseline"]["p95_ttft_ms"] > 0 and slo["baseline"]["p95_tpot_ms"] > 0
    before = allocation_records(store)
    assert sorted(before) == mine["knd"]["replica_claims"]

    again = serve.main(SERVE[:-4] + ["--slots", "3", "--new-tokens", "4", "--device", "cpu",
                                     "--state-dir", state, "--node-plane"])
    out = capsys.readouterr().out
    assert "[knd] recovered" in out and "'adopted': 2" in out
    assert len(again["knd"]["replica_claims"]) == 3
    store, _ = recover_store(state)
    after = allocation_records(store)
    assert {k: after[k] for k in before} == before
    assert len(set(after) - set(before)) == 1


def jax_plan_summary(d, m):
    cluster = build_tpu_cluster(1, TpuPodSpec(x=max(d, m), y=max(d, m)))
    reg = jcore.DriverRegistry()
    reg.add(jcore.TpuDriver(cluster)).add(jcore.IciDriver(cluster))
    plane = JaxControlPlane(reg, cluster)
    plane.run_discovery()
    plane.submit(plane.planner.make_claim("train", d * m))
    plane.submit(JaxWorkload(claim="train", placement="aligned", seed=0, build_mesh=False,
                             axes=[jcore.AxisSpec("data", d, "y"),
                                   jcore.AxisSpec("model", m, "x")]), name="train-job")
    return plane.wait_for("Workload", "train-job").status.outputs["plan"].summary()


TRAIN = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "16"]


def test_train_launcher_on_four_gloo_ranks(capsys, tmp_path):
    meshed = train.main(TRAIN + ["--mesh", "2x2", "--devices", "4",
                                 "--state-dir", str(tmp_path / "state")])
    out = capsys.readouterr().out
    plain = train.main(TRAIN)
    assert meshed["knd"]["plan"] == jax_plan_summary(2, 2)
    assert f"[knd] {meshed['knd']['plan']}" in out
    assert meshed["knd"]["mesh"] == {"data": 2, "model": 2}
    assert meshed["knd"]["informer"]["panics"] == 0
    assert meshed["result"]["completed"] == plain["result"]["completed"] == 2
    for got, want in zip(meshed["losses"], plain["losses"]):
        assert math.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (meshed, plain)
    assert all(math.isfinite(g) for g in meshed["grad_norms"])
    store, _ = recover_store(str(tmp_path / "state"))
    before = allocation_records(store)
    assert sorted(before) == ["train"]

    # a second run on the same state: rank 0 recovers it, the other ranks
    # start from its store, and all four adopt the claim and plan alike
    again = train.main(TRAIN + ["--mesh", "2x2", "--devices", "4", "--node-plane",
                                "--state-dir", str(tmp_path / "state")])
    out = capsys.readouterr().out
    assert "[knd] recovered" in out and "[knd] node plane" in out
    assert again["knd"]["adopted"]["adopted"] == 1
    assert again["knd"]["plan"] == meshed["knd"]["plan"]
    assert again["knd"]["allocation_records"] == before
    assert again["losses"] == meshed["losses"]
    store, _ = recover_store(str(tmp_path / "state"))
    assert allocation_records(store) == before


@pytest.mark.parametrize("arch,smoke,device,want", [
    (ARCH, False, "cuda", "kernel"), ("hymba-1.5b", False, "cuda", "kernel"),
    ("arctic-480b", False, "cuda", "kernel"), (ARCH, False, "cpu", "auto"),
    (ARCH, True, "cuda", "auto")])
def test_train_launcher_attends_through_the_kernel_where_it_is_built(arch, smoke, device,
                                                                     want):
    from repro_torch.configs.registry import get_config, smoke_config
    cfg = smoke_config(arch) if smoke else get_config(arch)
    assert train.attention_impl(cfg, torch.device(device)) == want


def test_train_launcher_refuses_a_mesh_that_does_not_fit():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        train.main(TRAIN + ["--mesh", "2x2", "--devices", "1"])


# ---------------------------------------------------------------------------
# launch/mesh.py: planned meshes through the declarative plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,names", [
    ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
    ((2, 4, 4), ("pod", "data", "model")), ((16, 8, 2), ("data", "expert", "model"))])
def test_planned_mesh_for_matches_jax(shape, names):
    from repro.api.persistence import encode as jencode
    from repro.launch import mesh as jmesh
    from repro_torch.api.persistence import encode as tencode
    from repro_torch.launch import mesh as tmesh
    tm, tplan = tmesh.planned_mesh_for(shape, names, build_mesh=False)
    jm, jplan = jmesh.planned_mesh_for(shape, names, build_mesh=False)
    assert tm is None and jm is None
    assert tplan.summary() == jplan.summary()
    assert (json.dumps(tencode(tplan.attachment()), sort_keys=True)
            == json.dumps(jencode(jplan.attachment()), sort_keys=True))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_axis_specs_match_jax(multi_pod):
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    assert ([(a.name, a.size, a.physical) for a in tmesh.mesh_axis_specs(multi_pod)]
            == [(a.name, a.size, a.physical) for a in jmesh.mesh_axis_specs(multi_pod)])


def test_planned_mesh_for_builds_a_device_mesh(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    try:
        mesh, plan = tmesh.planned_mesh_for((1, 1), ("data", "model"), device_type="cpu")
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.tolist() == [[0]] and plan.summary().startswith("MeshPlan[aligned]")
        with pytest.raises(RuntimeError, match="process group has 1 ranks"):
            tmesh.planned_mesh_for((2, 2), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()
