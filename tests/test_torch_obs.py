"""The port's observability plane (``repro_torch.obs``) against the JAX package's, on the CPU.

Instrument names compare modulo the map ``plane_`` -> ``plane_torch_``
(planelint's metrics-discipline pass forbids declaring one name twice
under ``src/``); wall times are never compared.

* the catalog: with every module of both packages imported, 27
  instruments on each side, a bijection under the name map with equal
  kind, labels, buckets and help text (the one table of names);
* registry semantics: one seeded sequence of ``inc``/``set``/``observe``
  on registries of both packages with a fake clock, a label set past
  ``MAX_LABEL_SETS`` and a disabled registry: equal Prometheus text,
  JSON form and quantiles;
* the two repairs: ``FaultInjector.summary()["delay_hist"]`` equal to
  JAX's for the same seeds and ``fire()`` calls (the histogram's
  bucket-interpolated percentiles, not nearest-rank ones), and
  ``RuntimeStats()`` carrying JAX's ``"obs"`` section with equal keys and
  counts on the same inline-driven world;
* control-plane worlds: the node-kill heal of ``tests/test_obs.py`` in
  both packages (the same span trees and cycle counts, equal workqueue
  and eviction counters), and the seeded threaded stress run of
  ``tests/chaos.py`` on the port's types (well-formed spans; every
  allocated claim's final cycle holds ``Allocated``);
* serving: the smoke config in f32 on JAX's weights through both
  packages' Router and ServeEngine: the same request spans, counters,
  TTFT/TPOT histogram counts and KV gauges;
* artifacts: the port's serve and train launchers with ``--obs-dir``
  write ``metrics.prom``, ``metrics.json`` and ``spans.json``, which the
  unchanged ``scripts/obsctl.py`` reads;
* the port and ``chip_smoke.py`` import neither JAX nor the JAX package.
"""

import importlib
import importlib.util
import json
import pkgutil
import random
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import chaos as jstress  # noqa: E402
import repro  # noqa: E402
import repro.api as japi  # noqa: E402
import repro.api.chaos as jchaos  # noqa: E402
import repro.api.runtime as jruntime  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.node as jnode  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.topology.tpu as jtpu  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.api.chaos as tchaos  # noqa: E402
import repro_torch.api.runtime as truntime  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.node as tnode  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.topology.tpu as ttpu  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.router import Router as JaxRouter  # noqa: E402
from repro.serve.slo import SloTracker as JaxSloTracker  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch.serve.slo import SloTracker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Side:
    def __init__(self, api, chaos, runtime, core, tpu, node, obs):
        self.api, self.chaos, self.runtime, self.core = api, chaos, runtime, core
        self.tpu, self.node, self.obs = tpu, node, obs


SIDES = {"jax": Side(japi, jchaos, jruntime, jcore, jtpu, jnode, jobs),
         "torch": Side(tapi, tchaos, truntime, tcore, ttpu, tnode, tobs)}


def torch_name(name):
    """The port's twin of a JAX instrument name."""
    assert name.startswith("plane_")
    return "plane_torch_" + name[len("plane_"):]


def renamed(jax_dict):
    return {torch_name(k): v for k, v in jax_dict.items()}


# ---------------------------------------------------------------------------
# Catalog and registry semantics
# ---------------------------------------------------------------------------

def src_instruments(catalog):
    """The declared instruments of ``src/`` (test files declare fixtures
    named ``plane_test_*`` / ``plane_torch_test_*``)."""
    return {n: h for n, h in catalog.items() if "_test_" not in n}


def test_catalog_matches_jax():
    for pkg in (repro, repro_torch):
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
    jcat = src_instruments(jobs.catalog())
    tcat = src_instruments(tobs.catalog())
    assert len(jcat) == len(tcat) == 27
    assert {torch_name(n) for n in jcat} == set(tcat)
    for name, h in jcat.items():
        t = tcat[torch_name(name)]
        assert (t.kind, t.labels, t.buckets, t.help) == (h.kind, h.labels, h.buckets, h.help)
    assert (tobs.PREFIX, tobs.DEFAULT_BUCKETS, tobs.MAX_LABEL_SETS) == \
        (jobs.PREFIX, jobs.DEFAULT_BUCKETS, jobs.MAX_LABEL_SETS)
    assert (tobs.METRICS_PROM, tobs.METRICS_JSON, tobs.SPANS_JSON) == \
        ("metrics.prom", "metrics.json", "spans.json")


FIXTURES = {
    name: (obs.counter(prefix + "parity_total", "parity counter"),
           obs.gauge(prefix + "parity_gauge", "parity gauge"),
           obs.histogram(prefix + "parity_seconds", "parity histogram",
                         buckets=(0.001, 0.01, 0.1, 1.0)),
           obs.counter(prefix + "parity_labeled_total", "parity labeled counter",
                       labels=("arm",)))
    for name, obs, prefix in (("jax", jobs, "plane_test_"),
                              ("torch", tobs, "plane_torch_test_"))}


def drive_registry(side, seed):
    """One seeded sequence of instrument operations on a fresh registry
    with a fake clock, then the same on a disabled one."""
    obs = SIDES[side].obs
    count, gauge, hist, labeled = FIXTURES[side]
    rng = random.Random(seed)
    clock = [100.0]
    reg = obs.MetricsRegistry(clock=lambda: clock[0])
    with obs.installed(reg):
        c, c2, g, h = count.cell(), count.cell(), gauge.cell(), hist.cell()
        for _ in range(300):
            op = rng.random()
            if op < 0.2:
                c.inc(rng.choice((1, 2.5)))
            elif op < 0.3:
                c2.inc()
            elif op < 0.45:
                g.set(rng.uniform(-5.0, 5.0))
            elif op < 0.55:
                g.inc()
                g.dec(0.25)
            elif op < 0.85:
                h.observe(rng.expovariate(20.0))
            else:
                with h.time():
                    clock[0] += rng.uniform(0.0, 2.0)
        for i, cell in enumerate([labeled.cell(arm=f"a{i}")
                                  for i in range(obs.MAX_LABEL_SETS + 3)]):
            cell.inc(i)
        snap = h.snapshot()
    off = obs.MetricsRegistry(enabled=False)
    with obs.installed(off):
        nulls = [count.cell(), hist.cell(), labeled.cell(arm="x")]
        nulls[0].inc()
        nulls[1].observe(1.0)
    assert all(n is obs.NULL_CELL for n in nulls)
    return reg, snap, off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_semantics_match_jax(seed):
    jreg, jsnap, joff = drive_registry("jax", seed)
    treg, tsnap, toff = drive_registry("torch", seed)
    jtext = jreg.render_prometheus()
    assert jtext.count("plane_test_parity_seconds_bucket") == 5
    assert treg.render_prometheus() == jtext.replace("plane_test_", "plane_torch_test_")
    assert treg.to_dict() == renamed(jreg.to_dict())
    assert json.loads(treg.render_json()) == renamed(json.loads(jreg.render_json()))
    assert treg.dropped_label_sets == jreg.dropped_label_sets == 3
    assert tsnap == jsnap and tsnap["count"] > 0
    for q in (0.5, 0.95, 0.99):
        assert tobs.quantile(tsnap, q) == jobs.quantile(jsnap, q)
    assert toff.render_prometheus() == joff.render_prometheus() == ""
    assert toff.to_dict() == joff.to_dict() == {}


# ---------------------------------------------------------------------------
# The repairs: chaos percentiles and the runtime's "obs" section
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 23, 42])
def test_injector_delay_percentiles_match_jax(seed, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    rng = random.Random(seed)
    calls = [(rng.choice(jchaos.SYNC_POINTS), rng.random() < 0.3) for _ in range(400)]
    out = {}
    for name, s in SIDES.items():
        with s.obs.installed(s.obs.MetricsRegistry()):
            inj = s.chaos.FaultInjector(
                seed, delay_points=("store.", "workqueue.", "runtime.", "serve."),
                delay_prob=0.4, max_delay_s=0.05, kill_prob=0.2, max_kills=5,
                latency_points={"rollout.stamp": 0.01, "router.": 0.002})
            for point, killable in calls:
                try:
                    inj.fire(point, killable=killable)
                except s.chaos.InjectedFault:
                    pass
            out[name] = inj.summary()
    hist = out["jax"]["delay_hist"]
    assert sum(h["count"] >= 5 for h in hist.values()) >= 3
    assert out["torch"]["delay_hist"] == hist
    assert out["torch"] == out["jax"]


def tpu_plane(s, side=4, **kw):
    cluster = s.tpu.build_tpu_cluster(1, s.tpu.TpuPodSpec(x=side, y=side))
    reg = s.core.DriverRegistry()
    reg.add(s.core.TpuDriver(cluster)).add(s.core.IciDriver(cluster))
    plane = s.api.ControlPlane(reg, cluster, **kw)
    plane.run_discovery()
    return plane


def chip_claim(s, name, count):
    c = s.core
    return c.ResourceClaim(name=name, spec=c.ClaimSpec(
        requests=[c.DeviceRequest(name="chips", device_class="tpu.google.com",
                                  count=count)], topology_scope="cluster"))


def runtime_stats_inline(s):
    """A seeded world reconciled through one ``ControlPlaneRuntime``'s
    worker path on this thread (the informer's round, by hand): every
    ready key in the plane's kind order, then the waiters."""
    rng = random.Random(5)
    plane = tpu_plane(s)
    rt = s.api.ControlPlaneRuntime(plane)
    for i in range(5):
        plane.submit(chip_claim(s, f"c{i}", rng.choice((1, 2, 4))))
    plane.submit(s.api.Workload(claim="c0", build_mesh=False), name="w0")
    plane.submit(s.api.Workload(claim="c3", build_mesh=False), name="w3")
    waiters = [s.runtime.ConditionWaiter("Workload", w, "Ready") for w in ("w0", "w3")]
    rt._waiters.extend(waiters)
    for _ in range(64):
        with rt.lock:
            plane.sync_inventory()
            plane._pump_events()
            plane._requeue_on_released_capacity()
            if len(plane.queue) == 0:
                break
            batch = plane.queue.pop_ready(plane._kind_order)
            if not batch:
                plane.queue.fast_forward()
                continue
        for key in batch:
            rt._reconcile_key(key)
        rt._resolve_waiters()
    assert all(w.done for w in waiters)
    return rt.stats()


def test_runtime_stats_carry_the_obs_section_as_jax():
    got = {}
    for name, s in SIDES.items():
        with s.obs.installed(s.obs.MetricsRegistry()):
            got[name] = runtime_stats_inline(s)
    j, t = got["jax"]["obs"], got["torch"]["obs"]
    assert set(got["torch"]) == set(got["jax"])
    assert set(t) == set(j) == {"reconcile_latency_by_kind", "waiter_wait"}
    assert set(t["reconcile_latency_by_kind"]) == set(j["reconcile_latency_by_kind"])
    assert {"ResourceClaim", "Workload"} <= set(j["reconcile_latency_by_kind"])
    for kind, lat in j["reconcile_latency_by_kind"].items():
        mine = t["reconcile_latency_by_kind"][kind]
        assert set(mine) == set(lat) == {"count", "p50_ms", "p95_ms"}
        assert mine["count"] == lat["count"] > 0
    assert set(t["waiter_wait"]) == set(j["waiter_wait"]) == {"count", "p50_ms"}
    assert t["waiter_wait"]["count"] == j["waiter_wait"]["count"] == 2
    assert got["torch"]["reconciled"] == got["jax"]["reconciled"]


# ---------------------------------------------------------------------------
# Control-plane worlds
# ---------------------------------------------------------------------------

def shape(spans):
    """Span trees without times: (kind, object, root name, children)."""
    return [(r.kind, r.obj, r.name, [c.name for c in r.children]) for r in spans]


def counts(metrics):
    """A registry's ``to_dict()`` without wall times: counter and gauge
    values, histogram counts."""
    return {name: [(s["labels"], s["value"] if "value" in s else s["count"])
                   for s in entry["samples"]]
            for name, entry in metrics.items()}


def node_kill_heal(s):
    """``tests/test_obs.py``'s TestNodeKillTrace world: a claim of 8 chips
    and its workload, one of the claim's nodes killed, the lease lapsed,
    healed."""
    cluster = s.tpu.build_tpu_cluster(1, s.tpu.TpuPodSpec(x=4, y=4))
    reg = s.core.DriverRegistry()
    reg.add(s.core.TpuDriver(cluster)).add(s.core.IciDriver(cluster))
    with s.obs.installed(s.obs.MetricsRegistry()) as registry:
        plane = s.api.ControlPlane(reg, cluster, reconcile_mode="inline")
        clock = [1000.0]
        plane.node_clock = lambda: clock[0]
        nplane = s.node.NodePlane(plane, lease_duration_s=0.5).start(start_threads=False)
        tracer = s.obs.Tracer().attach(plane.store)
        plane.submit(chip_claim(s, "c1", 8))
        plane.submit(s.api.Workload(claim="c1", build_mesh=False), name="w1")
        for _ in range(12):
            plane.reconcile()
        victim = sorted({a.ref.node for a in
                         plane.store.get("ResourceClaim", "c1").spec.allocation.devices})[0]
        nplane.agents[victim].kill()
        clock[0] += 10.0
        for agent in nplane.agents.values():
            agent.renew()
        for _ in range(12):
            plane.reconcile()
        assert plane.store.get("Workload", "w1").is_true("Ready", current=True)
        tracer.detach()
        metrics = registry.to_dict()
    return tracer.spans(), metrics


def test_node_kill_trace_matches_jax():
    jspans, jmetrics = node_kill_heal(SIDES["jax"])
    tspans, tmetrics = node_kill_heal(SIDES["torch"])
    assert tobs.validate_spans(tspans) == []
    assert shape(tspans) == shape(jspans)
    claim = [r for r in tspans if r.kind == "ResourceClaim" and r.obj == "c1"]
    assert len(claim) >= 2
    assert [c.name for c in claim[0].children][:3] == ["Scheduled", "Allocated", "Prepared"]
    assert "Ready" in [c.name for c in [r for r in tspans if r.kind == "Workload"][-1].children]
    mine = counts(tmetrics)
    theirs = renamed(counts(jmetrics))
    assert mine == theirs
    assert mine["plane_torch_node_evictions_total"] == [({}, 1.0)]
    assert mine["plane_torch_workqueue_enqueued_total"][0][1] > 0


def port_run_stress():
    """``tests/chaos.py``'s ``run_stress`` on the port's types: the same
    scenario, injector and always-attached tracer."""
    def make_tpu_plane(side=4, **kw):
        return tpu_plane(SIDES["torch"], side, **kw)

    def claim(name, count, selectors=()):
        return chip_claim(SIDES["torch"], name, count)

    names = {**jstress.__dict__, "ControlPlane": tapi.ControlPlane,
             "ControlPlaneRuntime": tapi.ControlPlaneRuntime,
             "FaultInjector": tapi.FaultInjector, "Workload": tapi.Workload,
             "chaos_hooks": tchaos, "ClaimSpec": tcore.ClaimSpec,
             "DeviceRequest": tcore.DeviceRequest,
             "ResourceClaimTemplate": tcore.ResourceClaimTemplate,
             "Tracer": tobs.Tracer, "chip_claim": claim,
             "make_tpu_plane": make_tpu_plane}
    fn = jstress.run_stress
    run = types.FunctionType(fn.__code__, names, fn.__name__, fn.__defaults__)
    run.__kwdefaults__ = fn.__kwdefaults__
    return run


@pytest.mark.parametrize("seed", [7, 23, 42])
def test_stress_tracer_spans_well_formed(seed):
    result, plane = port_run_stress()(seed, n_threads=2, n_claims=4, side=7, max_kills=3)
    assert isinstance(plane, tapi.ControlPlane) and isinstance(result.tracer, tobs.Tracer)
    spans = result.tracer.spans()
    assert spans
    assert tobs.validate_spans(spans) == []
    by_obj = {}
    for r in spans:
        by_obj.setdefault((r.kind, r.obj), []).append(r)
    allocated = [o for o in plane.store.list_objects("ResourceClaim") if o.spec.allocated]
    assert allocated
    for obj in allocated:
        cycles = by_obj.get(("ResourceClaim", obj.meta.name))
        assert cycles, f"no spans for allocated {obj.meta.name}"
        assert "Allocated" in [c.name for c in cycles[-1].children]
    assert any(e.get("ph") == "X" for e in result.tracer.chrome_trace()["traceEvents"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

PROMPTS = [list(range(1, 12)), [5, 9, 2, 7, 3], [], [11, 4, 8, 6, 1, 3, 9, 2]]


def serve_traced(side, weights):
    """The smoke config in f32 through a Router over one engine (2 slots,
    chunk 4) under a fresh registry and an installed tracer."""
    jcfg, tcfg, jp, tp = weights
    s = SIDES[side]
    with s.obs.installed(s.obs.MetricsRegistry()) as registry, \
            s.obs.installed_tracer(s.obs.Tracer()) as tracer:
        if side == "jax":
            router = JaxRouter(JaxSloTracker())
            eng = JaxServeEngine(jcfg, jp, batch_slots=2, max_len=64,
                                 prefill_chunk=4, name="eng-test")
        else:
            router = Router(SloTracker())
            eng = ServeEngine(tcfg, tp, batch_slots=2, max_len=64, prefill_chunk=4,
                              name="eng-test", device="cpu")
        router.add_replica("replica-0", eng)
        for p in PROMPTS:
            router.submit(p, max_new_tokens=4)
        done = router.run()
        metrics = registry.to_dict()
    tokens = {r.uid: (r.state, list(r.generated)) for r in done}
    return tokens, [r for r in tracer.spans() if r.kind == "Request"], metrics, eng.steps


def test_serving_emits_and_instruments_match_jax():
    jcfg = jax_smoke_config("yi-34b").replace(compute_dtype="float32",
                                              param_dtype="float32")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = smoke_config("yi-34b").replace(compute_dtype="float32", param_dtype="float32")
    weights = (jcfg, tcfg, jp, tp)
    jtok, jspans, jmetrics, jsteps = serve_traced("jax", weights)
    ttok, tspans, tmetrics, tsteps = serve_traced("torch", weights)
    assert ttok == jtok and tsteps == jsteps
    assert tobs.validate_spans(tspans) == []
    assert shape(tspans) == shape(jspans)
    assert [r.obj for r in tspans] == [f"eng-test:r{i}" for i in range(len(PROMPTS))]
    for r in tspans:
        want = ["queued"] if PROMPTS[int(r.obj.rsplit("r", 1)[1])] == [] else \
            ["queued", "prefill", "decode"]
        assert [c.name for c in r.children] == want
        assert r.children[0].t0 == r.t0 and r.children[-1].t1 == r.t1
    assert tspans[0].args == {"prompt_len": 11, "max_new_tokens": 4, "slot": 0, "tokens": 4}
    mine, theirs = counts(tmetrics), renamed(counts(jmetrics))
    assert mine == theirs
    n = len(PROMPTS)
    assert mine["plane_torch_serve_admitted_total"] == [({}, n - 1)]
    assert mine["plane_torch_serve_completed_total"] == [({}, n - 1)]
    assert mine["plane_torch_serve_failed_total"] == [({}, 1)]
    assert mine["plane_torch_serve_steps_total"] == [({}, tsteps)]
    assert mine["plane_torch_serve_ttft_seconds"] == [({"arm": "baseline"}, n - 1)]
    assert mine["plane_torch_serve_tpot_seconds"] == [({"arm": "baseline"}, n - 1)]
    assert mine["plane_torch_serve_request_latency_seconds"] == [({"arm": "baseline"}, n)]
    assert mine["plane_torch_serve_kv_used_blocks"] == [({}, 0)]
    assert mine["plane_torch_serve_kv_free_blocks"] == [({}, 8)]


# ---------------------------------------------------------------------------
# --obs-dir on both launchers, read by scripts/obsctl.py
# ---------------------------------------------------------------------------

def obsctl():
    spec = importlib.util.spec_from_file_location("obsctl", ROOT / "scripts" / "obsctl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trees(trace):
    """Chrome-trace events -> {root name: [child names]} (one thread per
    object; a root's children follow it on its thread)."""
    out, current = {}, {}
    for e in trace["traceEvents"]:
        if e["ph"] != "X":
            continue
        key = (e["pid"], e["tid"])
        if e["cat"] in ("lifecycle", "request") and "/" in e["name"]:
            current[key] = e["name"]
            out[e["name"]] = []
        else:
            out[current[key]].append(e["name"])
    return out


def read_with_obsctl(obs_dir, tmp_path, capsys):
    """``obsctl metrics`` and ``obsctl trace`` on an obs dir, both exit 0
    -> (the metrics text printed, the trace written)."""
    ctl = obsctl()
    capsys.readouterr()
    assert ctl.main(["metrics", "--obs-dir", str(obs_dir)]) == 0
    text = capsys.readouterr().out
    out = tmp_path / "trace.json"
    assert ctl.main(["trace", "--obs-dir", str(obs_dir), "--out", str(out)]) == 0
    return text, json.loads(out.read_text())


def test_serve_launcher_obs_dir(tmp_path, capsys):
    obs_dir = tmp_path / "obs"
    with tobs.installed(tobs.MetricsRegistry()):
        out = launch_serve.main(["--smoke", "--device", "cpu", "--claim-chips", "1",
                                 "--obs-dir", str(obs_dir)])
    assert set(out["obs"]) == {"metrics.prom", "metrics.json", "spans.json"}
    assert all(Path(p).is_file() and Path(p).parent == obs_dir for p in out["obs"].values())
    assert tobs.active() is tobs.default_registry() and tobs.active_tracer() is None
    metrics = counts(json.loads((obs_dir / "metrics.json").read_text()))
    n = out["completed"]
    assert n == 8
    assert metrics["plane_torch_serve_admitted_total"] == [({}, n)]
    assert metrics["plane_torch_serve_completed_total"] == [({}, n)]
    assert metrics["plane_torch_serve_ttft_seconds"] == [({"arm": "baseline"}, n)]
    assert metrics["plane_torch_serve_steps_total"][0][1] > 0
    assert metrics["plane_torch_workqueue_enqueued_total"][0][1] > 0
    text, trace = read_with_obsctl(obs_dir, tmp_path, capsys)
    assert text == (obs_dir / "metrics.prom").read_text()
    assert f"plane_torch_serve_completed_total {n}\n" in text
    roots = trees(trace)
    requests = [k for k in roots if k.startswith("Request/")]
    assert len(requests) == n
    assert all(roots[k] == ["queued", "prefill", "decode"] for k in requests)
    claims = [k for k in roots if k.startswith("ResourceClaim/")]
    assert len(claims) == 4 == len(out["knd"]["replica_claims"])
    assert all(roots[k] == ["Allocated", "Prepared"] for k in claims)
    assert roots["Workload/serve#cycle0"][-1] == "Ready"


def test_train_launcher_obs_dir(tmp_path, capsys):
    obs_dir = tmp_path / "obs"
    with tobs.installed(tobs.MetricsRegistry()):
        out = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                                 "--seq", "16", "--obs-dir", str(obs_dir)])
    assert out["result"]["completed"] == 2
    text = capsys.readouterr().out
    assert f"[obs] artifacts: {obs_dir / 'metrics.json'}, {obs_dir / 'metrics.prom'}, " \
           f"{obs_dir / 'spans.json'}" in text
    # no plane and no engine: nothing to record, and still three artifacts
    assert json.loads((obs_dir / "metrics.json").read_text()) == {}
    assert read_with_obsctl(obs_dir, tmp_path, capsys) == ("", {
        "traceEvents": [], "displayTimeUnit": "ms"})


def test_train_launcher_obs_dir_traces_the_mesh_workload(tmp_path):
    obs_dir = tmp_path / "obs"
    with tobs.installed(tobs.MetricsRegistry()):
        launch_train.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
                           "--seq", "16", "--mesh", "1x1", "--devices", "1",
                           "--obs-dir", str(obs_dir)])
    roots = trees(json.loads((obs_dir / "spans.json").read_text()))
    assert roots["ResourceClaim/train#cycle0"] == ["Allocated", "Prepared"]
    assert roots["Workload/train-job#cycle0"][-1] == "Ready"
    metrics = counts(json.loads((obs_dir / "metrics.json").read_text()))
    assert [k for k, _ in metrics["plane_torch_runtime_reconcile_seconds"]] == \
        [{"kind": "ResourceClaim"}, {"kind": "Workload"}]


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert [f.name for f in files if pattern.search(f.read_text())] == []
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
import repro_torch, chip_smoke
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))
            or m == "repro"], sorted(sys.modules)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
