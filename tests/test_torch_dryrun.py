"""The dry run, the roofline and the hillclimb of the port, on the CPU.

The port traces a step on fake tensors over a fake process group
(``repro_torch.launch.dryrun``) where the JAX package compiles it
through XLA; these tests hold what the two share against JAX's: the
shape suite and its abstract inputs, the roofline's arithmetic and its
tables (on JAX's TPU constants, passed in by the test only), the
two-point extrapolation, the argument bytes of a sharded train cell and
the hillclimb's catalog. JAX's ``launch/dryrun.py`` and
``launch/hillclimb.py`` set ``XLA_FLAGS`` to 512 devices at import, so
they are imported in one subprocess (one thread), started with the
module and read by the tests that need it. Every test that makes a fake
process group destroys it and checks that none is left.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro.topology import tpu as jtpu  # noqa: E402

from repro_torch.configs import SHAPES, ShapeSpec, cache_specs, input_specs, shape_applicable  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hillclimb import ITERS  # noqa: E402
from repro_torch.launch.mesh import planned_mesh_for  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from repro_torch.roofline import analysis, report  # noqa: E402
from repro_torch.roofline.counters import StepCounter, collective_bytes_by_axis_kind  # noqa: E402
from repro_torch.train.train_step import StepConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TIMEOUT_S = 300

# JAX's TPU constants as the port's spec: every non-pod axis on ICI, the
# pod axis on DCN; for this test only (the port states no TPU number)
V5E = analysis.HardwareSpec("tpu-v5e", jtpu.PEAK_BF16_TFLOPS * 1e12, jtpu.HBM_BW * 1e9,
                            16 * 2**30, jtpu.ICI_BW * 1e9 * 2, jtpu.DCN_HOST_BW * 1e9 / 4,
                            1 << 30)

EXTRAP_IN = (
    {"flops": 10.0, "hlo_bytes": 100.0, "collectives": {"all-gather": 5.0},
     "collectives_by_axis": {"data": {"all-gather": 5.0}}},
    {"flops": 17.0, "hlo_bytes": 130.0,
     "collectives": {"all-gather": 8.0, "all-reduce": 2.0},
     "collectives_by_axis": {"data": {"all-gather": 8.0}, "model": {"all-reduce": 2.0}}},
    24)

# the smoke train cell held against JAX's argument bytes, on a 2 x 2 mesh
SMOKE_ARCH, SMOKE_BATCH, SMOKE_SEQ = "h2o-danube-1.8b", 8, 32

JAX_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from repro.launch import dryrun as d
from repro.launch.hillclimb import ITERS
from repro.configs.registry import smoke_config
from repro.configs.shapes import ShapeSpec
from repro.parallel.sharding import ShardingRules
c1, c2, L = json.loads(sys.argv[1])
arch, batch, seq = json.loads(sys.argv[2])
import numpy as np
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cell = d._compile_once(smoke_config(arch), ShapeSpec("smoke", seq, batch, "train"), mesh,
                       ShardingRules(mesh=mesh), unroll=True, donate=True)
print(json.dumps({"iters": ITERS, "extrapolate": d._extrapolate(c1, c2, L),
                  "argument_bytes": cell["memory"]["argument_bytes"],
                  "flops": cell["flops"]}))
"""


@pytest.fixture(scope="module")
def jax_side():
    """JAX's dry-run side, computed in a subprocess started with the
    module; the first test that reads it waits for it."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, json.dumps(EXTRAP_IN),
                             json.dumps([SMOKE_ARCH, SMOKE_BATCH, SMOKE_SEQ])],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    box = {}

    def result():
        if "out" not in box:
            try:
                out, err = proc.communicate(timeout=JAX_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            assert proc.returncode == 0, err.decode(errors="replace")[-3000:]
            box["out"] = json.loads(out.decode().strip().splitlines()[-1])
        return box["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture
def no_group_left():
    yield
    assert not dist.is_initialized()


def fake_mesh(shape, names):
    """A mesh over the fake group (the dry run plans its own through the
    KND path; these small ones need no plan)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# -- the shape suite ------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_equal_jax(jax_side, arch):
    jax_side                                      # started: the subprocess runs meanwhile
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = jshapes.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        assert shape_applicable(cfg, shape) == jshapes.shape_applicable(jcfg, jshape)
        ours, theirs = input_specs(cfg, shape), jshapes.input_specs(jcfg, jshape)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].device.type == "meta"
            assert tuple(ours[k].shape) == tuple(theirs[k].shape), (arch, name, k)
            assert str(ours[k].dtype) == f"torch.{theirs[k].dtype}", (arch, name, k)
        if shape.kind != "decode" or not shape_applicable(cfg, shape)[0]:
            continue
        c, jc = cache_specs(cfg, shape), jshapes.cache_specs(jcfg, jshape)

        def flat(t, prefix=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    yield from flat(v, f"{prefix}/{k}")
            else:
                yield prefix, (tuple(t.shape), str(t.dtype).replace("torch.", ""))

        assert dict(flat(c)) == dict(flat(jc)), (arch, name)


# -- the roofline's arithmetic and tables ---------------------------------------


def records():
    base = {"kind": "train", "devices": 512, "params": 1_831_198_720,
            "active_params": 1_831_198_720, "status": "ok",
            "memory": {"argument_bytes": 3 * 2**30, "output_bytes": 2**30,
                       "temp_bytes": 20 * 2**30, "alias_bytes": 2**30,
                       "per_device_bytes": 23 * 2**30}}
    return [
        {**base, "arch": "h2o-danube-1.8b", "shape": "train_4k", "mesh": "2x16x16",
         "axes": ["pod", "data", "model"], "flops": 3.1e13, "hlo_bytes": 2.2e12,
         "collectives": {"all-gather": 4e10, "all-reduce": 3e9},
         "collectives_by_axis": {"pod": {"all-reduce": 3e9}, "model": {"all-gather": 3e10},
                                 "data": {"all-gather": 1e10}}},
        {**base, "arch": "yi-34b", "shape": "decode_32k", "kind": "decode", "mesh": "16x16",
         "axes": ["data", "model"], "devices": 256, "flops": 1.2e11, "hlo_bytes": 9e10,
         "collectives": {"all-reduce": 2e8}},
        {**base, "arch": "mamba2-780m", "shape": "prefill_32k", "kind": "prefill",
         "mesh": "16x16", "axes": ["data", "model"], "devices": 256, "flops": 4e12,
         "hlo_bytes": 1e11, "memory": {**base["memory"], "per_device_bytes": 15 * 2**30},
         "collectives": {}, "collectives_by_axis": {}},
        {"arch": "yi-34b", "shape": "long_500k", "status": "skipped", "reason": "x"},
        {"arch": "arctic-480b", "shape": "train_4k", "status": "error", "error": "e"},
    ]


@pytest.mark.parametrize("dilation", [None, report.UNALIGNED_DILATION_16])
def test_roofline_terms_and_tables_equal_jax_on_its_constants(dilation):
    for rec in records():
        if rec["status"] != "ok":
            continue
        ours = analysis.roofline_terms(rec, dilation=dilation, hw=V5E)
        theirs = janalysis.roofline_terms(rec, dilation=dilation)
        for field in ("arch", "shape", "mesh", "dominant", "model_flops",
                      "hlo_flops_total", "useful_ratio", "per_device_gib", "compute_s",
                      "memory_s", "collective_s", "step_time_s", "no_overlap_step_s"):
            assert getattr(ours, field) == pytest.approx(getattr(theirs, field), rel=1e-12), field
        assert ours.mfu_bound() == pytest.approx(theirs.mfu_bound(), rel=1e-12)
    assert report.render_table(records(), dilation=dilation, hw=V5E) == \
        jreport.render_table(records(), dilation=dilation)
    assert report.render_memory_table(records(), hbm_gib=16.0) == \
        jreport.render_memory_table(records(), hbm_gib=16.0)


def test_h100_link_classes():
    """Inner axes first into a node of 8: a 16-wide axis leaves the node;
    the pod axis always does; span<n> by its n."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    hw = analysis.H100
    assert analysis.link_class("model", sizes, hw) == "inter"
    assert analysis.link_class("pod", sizes, hw) == "inter"
    assert analysis.link_class("model", {"data": 16, "model": 8}, hw) == "intra"
    assert analysis.link_class("data", {"data": 16, "model": 8}, hw) == "inter"
    assert analysis.link_class("etp", {"data": 16, "expert": 8, "etp": 2}, hw) == "intra"
    assert analysis.link_class("expert", {"data": 16, "expert": 8, "etp": 2}, hw) == "inter"
    assert analysis.link_class("span4", sizes, hw) == "intra"
    assert analysis.link_class("span256", sizes, hw) == "inter"


def test_unaligned_dilation_matches_the_port_planner():
    """report.py's 8.03 (the JAX package's constant) is the largest
    per-axis mean ring dilation of the planner's unaligned 16 x 16 plan
    (seed 0: 8.0234), to the constant's two decimals."""
    _, plan = planned_mesh_for((16, 16), ("data", "model"), placement="unaligned",
                               build_mesh=False)
    got = max(mean for mean, _ in plan.dilation.values())
    assert abs(got - report.UNALIGNED_DILATION_16[""]) <= 0.01, plan.dilation


# -- the counters -------------------------------------------------------------------


def test_all_gather_over_data_is_recorded_under_data(no_group_left):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import empty as dt_empty
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("data", "model"))
        with FakeTensorMode():
            x = dt_empty((8, 4), dtype=torch.float32, device_mesh=mesh,
                         placements=[Shard(0), Replicate()])
            with StepCounter(mesh) as c:
                x.redistribute(mesh, [Replicate(), Replicate()])
    assert collective_bytes_by_axis_kind(c) == {"data": {"all-gather": 8 * 4 * 4}}
    assert c.flops == 0


def smoke_cell(arch="h2o-danube-1.8b", layers=2, dtype="float32", remat="none"):
    cfg = smoke_config(arch).replace(num_layers=layers, param_dtype=dtype,
                                     compute_dtype=dtype)
    return cfg, ShapeSpec("smoke", 16, 4, "train"), StepConfig(remat=remat)


def hand_matmul_flops(cfg, B, S):
    """Forward matmul FLOPs of a dense smoke step from its shapes, times
    3 (each product's two gradients in the backward)."""
    T, D, H, K = B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F, V = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    layer = (2 * T * D * (H + 2 * K) * hd          # q, k, v
             + 2 * 2 * B * H * S * S * hd          # scores and P.V
             + 2 * T * H * hd * D                  # wo
             + 3 * 2 * T * D * F)                  # up, gate, down
    return 3 * (cfg.num_layers * layer + 2 * T * D * V)


def test_unsharded_matmul_flops_equal_a_hand_count():
    cfg, shape, sc = smoke_cell()
    got = dryrun._trace_once(cfg, shape, None, None, sc)
    assert got["flops"] == hand_matmul_flops(cfg, shape.global_batch, shape.seq_len)
    assert got["collectives"] == {}
    assert got["memory"]["per_device_bytes"] >= got["memory"]["argument_bytes"] > 0


def test_sharded_flops_are_the_unsharded_over_the_ranks(no_group_left):
    """On a 2 x 2 mesh every product of the smoke step is split over all 4
    ranks (batch on data; sequence, heads or hidden dim on model): the
    hand count over 4, with the counter's hook on DTensor's global-shape
    metadata ops in place."""
    cfg, shape, sc = smoke_cell()
    plain = dryrun._trace_once(cfg, shape, None, None, sc)
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("data", "model"))
        got = dryrun._trace_once(cfg, shape, mesh, ShardingRules(mesh=mesh), sc)
    assert got["flops"] == plain["flops"] / 4 == \
        hand_matmul_flops(cfg, shape.global_batch, shape.seq_len) / 4
    assert set(got["collectives_by_axis"]) == {"data", "model"}


def test_counter_refuses_a_torch_without_its_dtensor_hook(monkeypatch):
    """Without the hook DTensor's global-shape metadata ops would count
    as this rank's work and inflate every sharded cell: the counter
    raises instead, and leaves no mode entered."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    monkeypatch.delattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta_non_cached"):
        with StepCounter():
            pass
    assert torch.ones(2).sum().item() == 2


def test_fake_metadata_queries_move_no_bytes():
    """A fake tensor answers ``.device`` through a ``prim`` op: the trace's
    bytes equal those of the same step run on real CPU tensors."""
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg, shape, sc = smoke_cell(remat="full")
    got = dryrun._trace_once(cfg, shape, None, None, sc)
    opt = dryrun.pick_optimizer(cfg)
    state = init_train_state(cfg, opt, 0, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                              generator=g, dtype=torch.int32) for k in ("tokens", "labels")}
    c = StepCounter()
    with c:
        make_train_step(cfg, opt, sc)(state, batch)
    assert got["hlo_bytes"] == c.bytes and got["flops"] == c.flops
    assert got["bytes_by_op"] == dict(c.bytes_by_op)


@pytest.mark.parametrize("batch,mu,local", [(8, 2, True), (4, 4, False)])
def test_microbatches_of_a_sharded_batch(no_group_left, batch, mu, local):
    """A ``DTensor`` batch on a 2 x 2 mesh (rows over data): where 2 x mu
    divides the rows each rank cuts its microbatches from its own shard
    and moves nothing; otherwise the batch is gathered once over data and
    cut as the JAX package cuts it. Each microbatch is placed as a batch
    (one row of 4 is replicated: data does not divide it)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import batch_placements, use_rules
    from repro_torch.train.train_step import _microbatches
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("data", "model"))
        rules = ShardingRules(mesh=mesh)
        x = torch.arange(batch * 3, dtype=torch.int32).reshape(batch, 3)
        v = DTensor.from_local(x[:batch // 2], mesh, [Shard(0), Replicate()], run_check=False)
        with use_rules(rules), StepCounter(mesh) as c:
            mbs = _microbatches({"tokens": v}, mu)
        want = [Shard(0) if local else Replicate(), Replicate()]
        assert want == list(batch_placements(mbs[0]["tokens"], rules))
    assert len(mbs) == mu
    for i, mb in enumerate(mbs):
        t = mb["tokens"]
        assert tuple(t.shape) == (batch // mu, 3)
        assert list(t.placements) == want
        if local:
            n = batch // 2 // mu
            assert torch.equal(t.to_local(), x[i * n:(i + 1) * n])
    assert (collective_bytes_by_axis_kind(c) == {}) == local
    if not local:
        assert set(collective_bytes_by_axis_kind(c)) == {"data"}


def test_multi_pod_traffic_is_recorded_under_pod(no_group_left):
    """A pod x model mesh (2 x 2; the batch over ``("pod", "data")`` falls
    on ``pod``): the gradients' cross-pod reduction is under ``pod``. (A
    3-d mesh costs DTensor's strategy search ~40 s per trace; the
    2 x 16 x 16 ``--multi-pod`` run is the CLI's.)"""
    cfg, shape, sc = smoke_cell()
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("pod", "model"))
        got = dryrun._trace_once(cfg, shape, mesh, ShardingRules(mesh=mesh), sc)
    assert set(got["collectives_by_axis"]) == {"pod", "model"}
    assert got["collectives_by_axis"]["pod"].get("reduce-scatter", 0) + \
        got["collectives_by_axis"]["pod"].get("all-reduce", 0) > 0


def test_two_point_extrapolation_is_exact_for_a_uniform_stack(no_group_left):
    """1 and 2 layers extrapolated to 4 equal the 4-layer trace: FLOPs,
    bytes, collectives and memory (every per-layer cost is the same, and
    the stacked layers' gradients are stacked once, not summed)."""
    cfg, shape, _ = smoke_cell(layers=4, dtype="bfloat16")
    sc = StepConfig(remat="full")
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("data", "model"))
        rules = ShardingRules(mesh=mesh)
        c1, c2, c4 = (dryrun._trace_once(cfg.replace(num_layers=n), shape, mesh, rules, sc)
                      for n in (1, 2, 4))
    ext = dryrun._extrapolate(c1, c2, 4)
    assert ext["flops"] == c4["flops"] and ext["hlo_bytes"] == c4["hlo_bytes"]
    assert ext["collectives"] == c4["collectives"]
    assert ext["collectives_by_axis"] == c4["collectives_by_axis"]
    assert dryrun._extrapolate_memory(c1["memory"], c2["memory"], 4) == c4["memory"]


# -- lower_cell on the production mesh -----------------------------------------------


def test_lower_cell_traces_danube_on_the_16x16_mesh(no_group_left):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.lower_cell("h2o-danube-1.8b", shape)
        assert rec["status"] == "ok", rec
        assert rec["mesh"] == "16x16" and rec["devices"] == 256
        assert rec["counter"] == "torch-fake"
        assert rec["flops"] > 0 and rec["memory"]["per_device_bytes"] > 0
        assert set(rec["collectives_by_axis"]) <= {"data", "model"}
        r = analysis.roofline_terms(rec)
        assert r.step_time_s > 0 and r.dominant in ("compute", "memory", "collective")
        assert not dist.is_initialized()
    rec = dryrun.lower_cell("yi-34b", "long_500k")
    want = jshapes.shape_applicable(jax_get_config("yi-34b"), jshapes.SHAPES["long_500k"])
    assert rec == {"arch": "yi-34b", "shape": "long_500k", "status": "skipped",
                   "reason": want[1]}


# -- held against JAX's dry run (the subprocess) -------------------------------------


def test_extrapolate_equals_jax(jax_side):
    assert dryrun._extrapolate(*EXTRAP_IN) == jax_side()["extrapolate"]


def test_argument_bytes_of_a_smoke_train_cell_equal_jax(jax_side, no_group_left):
    """Per rank on a 2 x 2 mesh: the state and the batch, placed by the
    same rules, within 1 % of XLA's ``argument_size_in_bytes``."""
    cfg = smoke_config(SMOKE_ARCH)
    shape = ShapeSpec("smoke", SMOKE_SEQ, SMOKE_BATCH, "train")
    with dryrun.fake_group(4):
        mesh = fake_mesh((2, 2), ("data", "model"))
        got = dryrun._trace_once(cfg, shape, mesh, ShardingRules(mesh=mesh))
    want = jax_side()["argument_bytes"]
    assert abs(got["memory"]["argument_bytes"] - want) <= 0.01 * want, (got["memory"], want)
    # no assertion on FLOPs: XLA counts elementwise work, the port matmuls
    # only; shown with -s for the record
    print(f"[smoke {SMOKE_ARCH} {SMOKE_BATCH}x{SMOKE_SEQ}, 2 x 2] argument bytes: port "
          f"{got['memory']['argument_bytes']}, JAX {want}; flops per rank: port "
          f"{got['flops']:.6g}, JAX {jax_side()['flops']:.6g}")


def test_hillclimb_iters_equal_jax(jax_side):
    assert json.loads(json.dumps(ITERS)) == jax_side()["iters"]
