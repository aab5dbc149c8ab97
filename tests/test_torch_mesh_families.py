"""Every family but dense trained under a KND-planned mesh, on the CPU.

Four ranks over gloo (each a ``python -c`` process, rendezvous through a
file in ``tmp_path``, one thread each, joined with a timeout of its own)
run WORKER_SCRIPT once:

* the SSD chunk's ``DTensor`` path with a recording stand-in for its
  kernel (it writes its output through numpy, outside autograd, as the
  ctypes kernel does): x sharded over batch (data) and heads (model)
  reaches the kernel as the local (b/2, H/2) shard, C and B as the batch
  shard; outputs and gradients are 1e-6 of the plain version's on the
  full tensors, C's and B's gradients summed over the head shards;
* a (2, 2) data x model mesh planned through the KND core, and on it the
  smoke configs of mamba2-780m (ssm), hymba-1.5b (hybrid), grok-1-314b
  and arctic-480b (moe, capacity factor 1.0 so that choices are dropped),
  internvl2-1b (vision, with patch embeddings) and musicgen-medium
  (audio) in f32, from the JAX package's weights through
  ``repro_torch.convert``: 3 AdamW steps each (grok also Adafactor) of 8
  x 32 tokens, remat dots, attention through the flash wrapper, under
  ``use_rules(ShardingRules(mesh=...))`` and without. Each step's loss is
  within 1e-4 relative of the unsharded port's and of JAX's
  ``make_train_step`` on the same weights; the MoE drop counts are the
  unsharded run's; every parameter and optimizer leaf is a DTensor.

Then the train launcher with ``--arch mamba2-780m --smoke --mesh 2x2
--devices 4 --device cpu`` (it starts its own four ranks) completes with
finite losses.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro.train.train_step import StepConfig as JaxStepConfig  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_REL = 1e-4
# (arch, optimizer): every family but dense, grok under both optimizers
RUNS = [("mamba2-780m", "adamw"), ("hymba-1.5b", "adamw"), ("grok-1-314b", "adamw"),
        ("grok-1-314b", "adafactor"), ("arctic-480b", "adamw"), ("internvl2-1b", "adamw"),
        ("musicgen-medium", "adamw")]
MOE = ("grok-1-314b", "arctic-480b")


def f32_overrides(arch):
    """The smoke config's changes for these runs: f32, and for the MoE
    models a capacity factor of 1.0, under which a batch of 8 x 32 drops
    choices (at 1.25 every expert's 128 slots hold its choices)."""
    kw = {"param_dtype": "float32", "compute_dtype": "float32"}
    if arch in MOE:
        kw["capacity_factor"] = 1.0
    return kw


WORKER_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rdzv, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
runs = json.loads(sys.argv[5])

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.core import (AxisSpec, DriverRegistry, IciDriver, MeshPlanner,
                              MeshRuntime, StructuredAllocator, TpuDriver)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.models import layers
from repro_torch.parallel.sharding import ShardingRules, use_rules
from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster
from repro_torch.train.optimizer import Adafactor, AdamW
from repro_torch.train.schedule import constant_schedule
from repro_torch.train.train_step import StepConfig, make_train_step, shard_train_state
from repro_torch.tree import tree_leaves

dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
res = {"rank": rank}
rs = np.random.RandomState

# -- the SSD chunk on local shards, with a stand-in kernel ----------------------
mesh2 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
seen = []

def fake_ssd_chunk_fwd(C, B, x, dt, da):
    seen.append([list(C.shape), list(B.shape), list(x.shape), list(dt.shape), list(da.shape)])
    with torch.no_grad():
        outs = ssd_chunk_ref(C, B, x, dt, da)
    copies = []
    for o in outs:
        c = torch.empty_like(o)
        c.numpy()[...] = o.numpy()
        copies.append(c)
    return tuple(copies)

def card_ssd(C, B, x, dt, da):
    if any(t.requires_grad for t in (C, B, x, dt, da)) and torch.is_grad_enabled():
        return ssd_ops._SSDChunk.apply(C, B, x, dt, da)
    return ssd_ops._launch(C, B, x, dt, da)

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())

b, nc, Q, N, H, P = 4, 2, 8, 4, 4, 4
shapes = [(b, nc, Q, N), (b, nc, Q, N), (b, nc, Q, H, P), (b, nc, Q, H), (b, nc, Q, H)]
full = [torch.tensor(rs(10 + i).randn(*s), dtype=torch.float32) for i, s in enumerate(shapes)]
full[3] = full[3].abs() * 0.1                      # dt > 0
full[4] = -full[3] * torch.tensor(np.linspace(1.0, 16.0, H), dtype=torch.float32)   # da = dt * A
full = [t.requires_grad_(True) for t in full]
gs = [torch.tensor(rs(20 + i).randn(*s), dtype=torch.float32)
      for i, s in enumerate([(b, nc, Q, H, P), (b, nc, H, N, P), (b, nc, H)])]
want = ssd_chunk_ref(*full)
want_grads = torch.autograd.grad(want, full, gs)
pl_x, pl_cb = [Shard(0), Shard(3)], [Shard(0), Replicate()]
pl_h = [Shard(0), Shard(2)]
errs = {}
kernel = ssd_ops.ssd_chunk_fwd
ssd_ops.ssd_chunk_fwd = fake_ssd_chunk_fwd
for name, fn in (("stand_in", lambda *a: ssd_ops.on_shards(card_ssd, *a)),
                 ("cpu_path", ssd_ops.ssd_chunk)):
    ins = [distribute_tensor(t.detach(), mesh2, pl).requires_grad_(True)
           for t, pl in zip(full, [pl_cb, pl_cb, pl_x, pl_x, pl_x])]
    outs = fn(*ins)
    res.setdefault("ssd_out_placements", {})[name] = [[str(p) for p in o.placements]
                                                      for o in outs]
    sum((o * distribute_tensor(g, mesh2, pl)).sum()
        for o, g, pl in zip(outs, gs, [pl_x, pl_h, pl_h])).backward()
    errs[name] = ([rel(o.full_tensor(), w) for o, w in zip(outs, want)]
                  + [rel(t.grad.full_tensor(), w) for t, w in zip(ins, want_grads)])
ssd_ops.ssd_chunk_fwd = kernel
res["ssd_seen"] = seen
res["ssd_launches"] = ssd_ops.launches
res["ssd_errs"] = errs

# -- the families on a KND-planned data x model mesh ----------------------------
cluster = build_tpu_cluster(1, TpuPodSpec(x=2, y=2))
reg = DriverRegistry()
reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
reg.run_discovery()
planner = MeshPlanner(cluster)
claim = planner.make_claim("spmd", 4)
StructuredAllocator(reg.pool, reg.classes).allocate(claim)
plan = planner.plan([AxisSpec("data", 2, "y"), AxisSpec("model", 2, "x")], "aligned", claim)
mesh = MeshRuntime("cpu").execute(plan.attachment())
res["mesh"] = [list(mesh.mesh_dim_names), mesh.mesh.tolist()]

def fresh_state(arch, opt):
    weights = np.load(f"{out_dir}/{arch}.npz")
    tree = {}
    for key in weights.files:
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = weights[key]
    params = convert.params_from_jax(tree, "cpu")
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}

def run(run_cfg, rules):
    arch, opt_name, steps, batch, seq, overrides = run_cfg
    cfg = smoke_config(arch).replace(**overrides)
    opt = (AdamW if opt_name == "adamw" else Adafactor)(constant_schedule(1e-3))
    data = SyntheticLMData(cfg, batch, seq)
    drops = []
    route = layers._route

    def counting(cfg_, p, xt, *real):
        r = route(cfg_, p, xt, *real)
        drops.append(int((~r.keep).sum()))
        return r

    layers._route = counting
    try:
        with use_rules(rules):
            state = shard_train_state(cfg, opt, fresh_state(arch, opt))
            step = make_train_step(cfg, opt, StepConfig(remat="dots", attention_impl="kernel"))
            losses = []
            for s in range(steps):
                state, m = step(state, {k: torch.from_numpy(v) for k, v in data.batch(s).items()})
                losses.append(float(m["loss"]))
    finally:
        layers._route = route
    leaves = tree_leaves(state["params"]) + tree_leaves(state["opt_state"])
    return {"losses": losses, "drops": drops,
            "all_dtensor": all(isinstance(t, DTensor) and t.device_mesh is mesh
                               for t in leaves)}

res["sharded"], res["plain"] = {}, {}
for i, run_cfg in enumerate(runs):
    key = f"{run_cfg[0]}/{run_cfg[1]}"
    res["sharded"][key] = run(run_cfg, ShardingRules(mesh=mesh))
    if i % world == rank:          # the unsharded runs, spread over the ranks
        res["plain"][key] = run(run_cfg, None)
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), np.asarray(leaf)) for path, leaf in flat]


def jax_losses(jcfg, jp, opt_name):
    """JAX's unsharded make_train_step from the same weights and data."""
    opt = (jopt.AdamW if opt_name == "adamw" else jopt.Adafactor)(
        jsched.constant_schedule(1e-3))
    state = {"params": jp, "opt_state": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jax_make_train_step(jcfg, opt, JaxStepConfig(remat="dots")))
    data = JaxSyntheticLMData(jcfg, BATCH, SEQ)
    out = []
    for s in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in data.batch(s).items()})
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """WORKER_SCRIPT's results on 4 gloo ranks, and JAX's losses (taken
    while the ranks run) on the same weights."""
    out = tmp_path_factory.mktemp("mesh_families")
    jcfgs = {}
    for arch in sorted({a for a, _ in RUNS}):
        jcfgs[arch] = jax_smoke_config(arch).replace(**f32_overrides(arch))
        jp = jlm.init_params(jcfgs[arch], jax.random.PRNGKey(0))
        np.savez(out / f"{arch}.npz", **dict(jax_paths(jp)))
    runs = json.dumps([[a, o, STEPS, BATCH, SEQ, f32_overrides(a)] for a, o in RUNS])
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER_SCRIPT, str(r), "4",
                               str(out / "rdzv"), str(out), runs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    logs = []
    try:
        want = {f"{a}/{o}": jax_losses(jcfgs[a], jlm.init_params(jcfgs[a], jax.random.PRNGKey(0)), o)
                for a, o in RUNS}
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                        .decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    plain = {}
    for res in ranks:
        plain.update(res["plain"])
    return ranks, plain, want


def test_ssd_chunk_runs_on_local_head_shards(four_ranks):
    """x (4, 2, 8, 4, 4) sharded over batch on data and heads on model
    reaches the stand-in kernel as (2, 2, 8, 2, 4): the batch half and
    H/2 heads; C and B as their batch half. Outputs and gradients match
    the plain version on the full tensors."""
    ranks, _, _ = four_ranks
    for res in ranks:
        assert res["ssd_seen"] == [[[2, 2, 8, 4], [2, 2, 8, 4], [2, 2, 8, 2, 4],
                                    [2, 2, 8, 2], [2, 2, 8, 2]]]
        assert res["ssd_launches"] == 1
        for name, placements in res["ssd_out_placements"].items():
            assert placements == [["S(0)", "S(3)"], ["S(0)", "S(2)"], ["S(0)", "S(2)"]], name
        for name, errs in res["ssd_errs"].items():
            assert len(errs) == 8 and max(errs) <= 1e-6, (name, errs)


@pytest.mark.parametrize("run", [f"{a}/{o}" for a, o in RUNS])
def test_family_trains_under_the_mesh_as_unsharded_and_jax(four_ranks, run):
    ranks, plain, jax_want = four_ranks
    want = plain[run]
    for res in ranks:
        assert res["mesh"] == [["data", "model"], [[0, 1], [2, 3]]]
        got = res["sharded"][run]
        assert got["all_dtensor"]
        assert len(got["losses"]) == STEPS
        for a, b, j in zip(got["losses"], want["losses"], jax_want[run]):
            assert math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b), (got, want)
            assert abs(a - j) <= LOSS_REL * abs(j), (got["losses"], jax_want[run])
        assert got["drops"] == want["drops"]
    if run.split("/")[0] in MOE:
        assert sum(want["drops"]) > 0, want["drops"]


def test_train_launcher_trains_mamba2_on_four_gloo_ranks(capsys):
    out = launch_train.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "8", "--seq", "32",
                             "--mesh", "2x2", "--devices", "4"])
    assert out["knd"]["mesh"] == {"data": 2, "model": 2}
    assert out["result"]["completed"] == 2
    assert len(out["losses"]) == 2 and all(math.isfinite(l) for l in out["losses"])
    assert all(math.isfinite(g) for g in out["grad_norms"])
