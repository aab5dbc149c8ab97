"""The port's sharding rules, sharded training and int8 pod mean, on the CPU.

* ``logical_to_pspec`` against the JAX package's at the production
  meshes (16, 16) data x model and (2, 16, 16) pod x data x model, for
  every parameter of every registry arch and both optimizers' state
  (``param_specs`` and ``state_specs`` with the abstract trees); the
  logical axes themselves against JAX's ``param_specs``. Exact.
* ``constrain``: a no-op off a mesh and on a plain tensor, and a rank
  mismatch raises; ``placements`` and the layout of a dim sharded over
  a tuple of mesh axes against JAX's ``devices_indices_map``.
* Four ranks over gloo (each a ``python -c`` process, rendezvous
  through a file in ``tmp_path``, one thread each, joined with a
  timeout): the int8 pod mean on mesh (2, 2, 1) pod x data x model on
  the JAX package's compressed-sync problem (``tests/
  test_sharding_collectives.py``: relative error < 0.1, lower over two
  steps with error feedback, int8 in every SUM all_reduce); the kernel
  wrappers' DTensor paths with stand-in kernels (the sequence gathered
  before flash, the last dim before RMSNorm; outputs and gradients
  1e-6 of the plain version's); and sharded training on a KND-planned
  (2, 2) data x model mesh with the JAX package's SPMD config (smoke
  yi-34b, 4/2 heads, d_model 64, d_ff 128, AdamW at 1e-3, remat dots,
  8 x 32 tokens, 5 steps) in f32, each step's loss within 1e-4
  relative of the port's unsharded run and of the JAX package's, from
  the same weights through ``repro_torch.convert``; then a checkpoint of
  that sharded state (every rank gathers each leaf, rank 0 writes the
  JAX package's format) restored on every rank bit-equal, as DTensors on
  the same mesh and placements and into the unsharded tree, and read
  bit-equal by the JAX package's ``restore_checkpoint``.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.checkpoint import restore_checkpoint as jax_restore_checkpoint  # noqa: E402
from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jshard  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import schedule as jsched  # noqa: E402
from repro.train.train_step import StepConfig as JaxStepConfig  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import sharding as tshard  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import schedule as tsched  # noqa: E402
from repro_torch.train.train_step import abstract_train_state, train_state_specs  # noqa: E402
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120
MESHES = {"data16-model16": (("data", "model"), (16, 16)),
          "pod2-data16-model16": (("pod", "data", "model"), (2, 16, 16))}


# ---------------------------------------------------------------------------
# Specs at the production meshes
# ---------------------------------------------------------------------------

def rules_pair(mesh_key):
    names, shape = MESHES[mesh_key]
    jmesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape, object))
    tmesh = types.SimpleNamespace(axis_names=names, axis_sizes=shape)
    return jshard.ShardingRules(mesh=jmesh), tshard.ShardingRules(mesh=tmesh)


def jax_paths(tree):
    """(path, leaf) of a JAX tree whose leaves may be tuples, sorted keys."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in flat]


def jax_state(cfg, optimizer):
    """JAX's train-state specs and abstract state, params and opt_state."""
    pspecs = jlm.param_specs(cfg)
    abstract = jlm.abstract_params(cfg)
    return ({"params": pspecs, "opt_state": optimizer.state_specs(pspecs, abstract)},
            {"params": abstract, "opt_state": jax.eval_shape(optimizer.init, abstract)})


OPTIMIZERS = {"adamw": (jopt.AdamW, topt.AdamW), "adafactor": (jopt.Adafactor, topt.Adafactor)}


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_to_pspec_matches_jax(arch, opt_name, mesh_key):
    jrules, trules = rules_pair(mesh_key)
    jo, to = OPTIMIZERS[opt_name]
    jspecs, jabs = jax_state(jax_get_config(arch), jo(jsched.constant_schedule(1e-3)))
    cfg = get_config(arch)
    topt_ = to(tsched.constant_schedule(1e-3))
    tspecs = train_state_specs(cfg, topt_)
    tabs = abstract_train_state(cfg, topt_)
    for part in ("params", "opt_state"):
        js, ja = jax_paths(jspecs[part]), jax_paths(jabs[part])
        ts, ta = tree_flatten_with_paths(tspecs[part]), tree_flatten_with_paths(tabs[part])
        assert [k for k, _ in ts] == [k for k, _ in js] == [k for k, _ in ja]
        assert [tuple(a.shape) for _, a in ta] == [tuple(a.shape) for _, a in ja]
        for (key, taxes), (_, jaxes), (_, t), (_, j) in zip(ts, js, ta, ja):
            assert taxes == jaxes, key
            want = tuple(jshard.logical_to_pspec(jaxes, jrules, j.shape))
            assert tshard.logical_to_pspec(taxes, trules, tuple(t.shape)) == want, key
            assert tshard.logical_to_pspec(taxes, trules) == tuple(
                jshard.logical_to_pspec(jaxes, jrules)), key


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_rules_resolve_as_jax(mesh_key):
    """The rules of the JAX package's own unit tests: a missing axis is
    dropped, a mesh axis shards one dim, axes drop from the right until
    they divide, an unknown logical name raises."""
    jrules, trules = rules_pair(mesh_key)
    cases = [(("batch", None), None), (("seq", "act_ff"), None),
             (("act_heads",), (6,)), (("act_heads",), (32,)), (("batch", "seq"), (8, 32)),
             (("batch", "seq"), (2, 32)), (("batch", "seq"), (3, 5)),
             (("embed", "heads_tp", None), (2560, 32, 80)),
             (("layer", "embed", "kv_tp", None), (24, 2560, 8, 80))]
    for axes, shape in cases:
        assert tshard.logical_to_pspec(axes, trules, shape) == tuple(
            jshard.logical_to_pspec(axes, jrules, shape)), (axes, shape)
    with pytest.raises(KeyError):
        tshard.logical_to_pspec(("no_such_axis",), trules)
    assert tshard.BASE_RULES == jshard.BASE_RULES


def test_param_specs_cover_rules():
    for arch in ARCHS:
        for _, axes in tree_flatten_with_paths(lm.param_specs(smoke_config(arch))):
            assert all(ax is None or ax in tshard.BASE_RULES for ax in axes), (arch, axes)
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


def test_constrain_off_mesh_and_rank_mismatch():
    x = torch.zeros(2, 3)
    assert tshard.constrain(x, "batch", None) is x                     # no rules
    with tshard.use_rules(tshard.ShardingRules()):                     # no mesh
        assert tshard.constrain(x, "batch", None, None) is x
    mesh = types.SimpleNamespace(axis_names=("data", "model"), axis_sizes=(2, 2))
    with tshard.use_rules(tshard.ShardingRules(mesh=mesh)):
        assert tshard.constrain(x, "batch", None) is x                 # plain tensor
        with pytest.raises(ValueError, match="rank 2"):
            tshard.constrain(x, "batch", "seq", None)
        with tshard.use_rules(tshard.ShardingRules(mesh=mesh, enabled=False)):
            assert tshard.constrain(x, "batch", "seq", None) is x
    assert tshard.current_rules() is None


def test_placements_follow_mesh_dim_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"), axis_sizes=(2, 2, 1))
    assert tshard.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tshard.placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh-dim order"):
        tshard.placements((("data", "pod"),), mesh)


JAX_LAYOUT_SCRIPT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 1), ("pod", "data", "model"))
out = {}
for name, spec in (("pod_data", P(("pod", "data"))), ("data_pod", P(("data", "pod")))):
    m = NamedSharding(mesh, spec).devices_indices_map((8, 3))
    out[name] = {str(d.id): list(range(8))[s[0]] for d, s in m.items()}   # its rows
print(json.dumps(out))
"""


# ---------------------------------------------------------------------------
# Four ranks over gloo
# ---------------------------------------------------------------------------

WORKER_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rdzv, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.core import (AxisSpec, DriverRegistry, IciDriver, MeshPlanner,
                              MeshRuntime, StructuredAllocator, TpuDriver)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.parallel.collectives import make_compressed_grad_sync, zeros_like_tree
from repro_torch.parallel.sharding import (ShardingRules, current_rules, distribute_batch,
                                           placements, use_rules)
from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedule import constant_schedule
from repro_torch.train.train_step import StepConfig, make_train_step, shard_train_state
from repro_torch.tree import tree_leaves

dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
res = {"rank": rank}
rs = np.random.RandomState

# -- the layout of a batch and the int8 pod mean: pod x data x model ------------
mesh3 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                   mesh_dim_names=("pod", "data", "model"))
rules3 = ShardingRules(mesh=mesh3)
rows = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 3)
res["batch_rows"] = distribute_batch({"x": rows}, rules3)["x"].to_local()[:, 0].tolist()
try:
    placements((("data", "pod"),), mesh3)
    res["reversed_tuple"] = "accepted"
except ValueError:
    res["reversed_tuple"] = "refused"

wire = []
all_reduce = dist.all_reduce
def recording(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
    wire.append((str(op), str(tensor.dtype)))
    return all_reduce(tensor, op=op, group=group, async_op=async_op)
dist.all_reduce = recording

sub = mesh3["data", "model"]
w = torch.tensor(rs(0).randn(16, 4), dtype=torch.float32)
x = torch.tensor(rs(1).randn(8, 16), dtype=torch.float32)
y = torch.tensor(rs(2).randn(8, 4), dtype=torch.float32)
params = {"w": distribute_tensor(w, sub, [Replicate(), Replicate()])}

def grad_fn(p, batch):
    b = distribute_batch(batch, current_rules())
    live = p["w"].detach().requires_grad_(True)
    loss = torch.mean((b["x"] @ live - b["y"]) ** 2)
    g, = torch.autograd.grad(loss, [live])
    return {"w": g}, {"loss": loss.detach()}

with use_rules(rules3):
    sync = make_compressed_grad_sync(mesh3, grad_fn)
    err = zeros_like_tree(params, torch.float32)
    g_c, new_err, metrics = sync(params, {"x": x, "y": y}, err)
    g2, _, _ = sync(params, {"x": x, "y": y}, new_err)
dist.all_reduce = all_reduce
live = w.clone().requires_grad_(True)
exact_loss = torch.mean((x @ live - y) ** 2)
exact, = torch.autograd.grad(exact_loss, [live])
gc, g2f = g_c["w"].full_tensor(), g2["w"].full_tensor()
top = float(exact.abs().max())
res["pod_mean"] = {
    "rel": float((gc - exact).abs().max()) / top,
    "rel2": float(((gc + g2f) / 2 - exact).abs().max()) / top,
    "loss": float(metrics["loss"]), "exact_loss": float(exact_loss),
    "dtensor": isinstance(g_c["w"], DTensor) and isinstance(new_err["w"], DTensor),
    "sums": {d: sum(1 for o, d_ in wire if "SUM" in o and d_ == d) for _, d in wire},
    "maxes": {d: sum(1 for o, d_ in wire if "MAX" in o and d_ == d) for _, d in wire}}

# -- the kernel wrappers' DTensor paths, with stand-in kernels ------------------
mesh2 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
seen = []

def outside_autograd(value):
    out = torch.empty_like(value)
    out.detach().numpy()[...] = value.detach().numpy()
    return out

def fake_rmsnorm_fwd(x, scale, eps):
    seen.append(["rmsnorm", list(x.shape)])
    with torch.no_grad():
        return outside_autograd(rmsnorm_ref(x, scale, eps))

def fake_flash_forward(q, k, v, causal, window):
    seen.append(["flash", list(q.shape), list(k.shape)])
    flash_ops.launches += 1
    with torch.no_grad():
        return outside_autograd(attention_ref(q, k, v, causal=causal, window=window))

def card_rmsnorm(x, scale, eps=1e-6):
    if (x.requires_grad or scale.requires_grad) and torch.is_grad_enabled():
        return rmsnorm_ops._RMSNorm.apply(x, scale, eps)
    return rmsnorm_ops._launch(x, scale, eps)

kernels = (rmsnorm_ops.rmsnorm_fwd, flash_ops._forward)
rmsnorm_ops.rmsnorm_fwd = fake_rmsnorm_fwd
flash_ops._forward = fake_flash_forward

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())

errs = {}
xs = torch.tensor(rs(3).randn(4, 6, 8), dtype=torch.float32, requires_grad=True)
sc = torch.tensor(1 + 0.1 * rs(4).randn(8), dtype=torch.float32, requires_grad=True)
gy = torch.tensor(rs(5).randn(4, 6, 8), dtype=torch.float32)
xd = distribute_tensor(xs.detach(), mesh2, [Shard(0), Shard(2)]).requires_grad_(True)
sd = distribute_tensor(sc.detach(), mesh2, [Replicate(), Replicate()]).requires_grad_(True)
out = rmsnorm_ops.on_shards(card_rmsnorm, xd, sd, 1e-6)
res["rmsnorm_out_placements"] = [str(p) for p in out.placements]
(out * distribute_tensor(gy, mesh2, [Shard(0), Shard(2)])).sum().backward()
want = rmsnorm_ref(xs, sc, 1e-6)
wx, ws = torch.autograd.grad(want, (xs, sc), gy)
errs["rmsnorm"] = [rel(out.full_tensor(), want), rel(xd.grad.full_tensor(), wx),
                   rel(sd.grad.full_tensor(), ws)]

for case, H, K, qpl, kpl in (("seq", 4, 2, [Shard(0), Shard(1)], [Shard(0), Shard(1)]),
                              ("heads", 4, 2, [Shard(0), Shard(2)], [Shard(0), Shard(2)]),
                              ("heads_k1", 4, 1, [Shard(0), Shard(2)], [Shard(0), Replicate()])):
    q, k, v = (torch.tensor(rs(6 + i).randn(4, 8, n, 16), dtype=torch.float32,
                            requires_grad=True) for i, n in enumerate((H, K, K)))
    g = torch.tensor(rs(9).randn(4, 8, H, 16), dtype=torch.float32)
    qd = distribute_tensor(q.detach(), mesh2, qpl).requires_grad_(True)
    kd, vd = (distribute_tensor(t.detach(), mesh2, kpl).requires_grad_(True) for t in (k, v))
    out = flash_ops.flash_attention(qd, kd, vd, causal=True, window=0)
    (out * distribute_tensor(g, mesh2, qpl)).sum().backward()
    want = attention_ref(q, k, v, causal=True, window=0)
    wg = torch.autograd.grad(want, (q, k, v), g)
    errs["flash_" + case] = [rel(out.full_tensor(), want)] + [
        rel(t.grad.full_tensor(), w_) for t, w_ in zip((qd, kd, vd), wg)]
res["wrapper_errs"] = errs
res["seen"] = seen
res["launches"] = {"rmsnorm": rmsnorm_ops.launches, "flash": flash_ops.launches}
rmsnorm_ops.rmsnorm_fwd, flash_ops._forward = kernels

# -- sharded training on a KND-planned data x model mesh ------------------------
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

cfg = smoke_config("yi-34b").replace(num_heads=4, num_kv_heads=2, d_model=64, d_ff=128,
                                     compute_dtype="float32", param_dtype="float32")
opt = AdamW(constant_schedule(1e-3))
data = SyntheticLMData(cfg, 8, 32)
weights = np.load(f"{out_dir}/weights.npz")

def fresh_state():
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

def run(rules):
    with use_rules(rules):
        state = shard_train_state(cfg, opt, fresh_state())
        step = make_train_step(cfg, opt, StepConfig(remat="dots", attention_impl="kernel"))
        losses = []
        for s in range(5):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses, state

res["losses_sharded"], st = run(ShardingRules(mesh=mesh))
res["all_dtensor"] = all(isinstance(p, DTensor) and p.device_mesh is mesh
                         for p in tree_leaves(st["params"]) + tree_leaves(st["opt_state"]))
res["losses_plain"], _ = run(None)

# -- the sharded state's checkpoint: gathered on every rank, rank 0 writes ------
from repro_torch.ckpt.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.tree import tree_flatten_with_paths
ck = f"{out_dir}/ckpt"
mgr = CheckpointManager(ck)
mgr.save(5, st)
mgr.wait()                       # a barrier: rank 0 has committed
full = [(k, v.full_tensor() if isinstance(v, DTensor) else v)
        for k, v in tree_flatten_with_paths(st)]
if rank == 0:
    np.savez(f"{out_dir}/ckpt_state.npz", **{k: v.numpy() for k, v in full})
with use_rules(ShardingRules(mesh=mesh)):
    like = shard_train_state(cfg, opt, fresh_state())
sharded, step_s = restore_checkpoint(ck, like)
plain, step_p = restore_checkpoint(ck, fresh_state())
checks = []
for (k, want), (_, l), (_, got), (_, p) in zip(full, tree_flatten_with_paths(like),
                                               tree_flatten_with_paths(sharded),
                                               tree_flatten_with_paths(plain)):
    dt = isinstance(l, DTensor)
    checks.append({
        "key": k, "dtensor": dt,
        "same_layout": (isinstance(got, DTensor) and got.device_mesh is mesh
                        and got.placements == l.placements) if dt
                       else not isinstance(got, DTensor),
        "bit_equal": torch.equal(got.full_tensor() if dt else got, want),
        "plain_bit_equal": not isinstance(p, DTensor) and torch.equal(p, want)})
res["ckpt"] = {"dir": ck, "steps": [step_s, step_p], "leaves": checks}
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def spmd_config_jax():
    return jax_smoke_config("yi-34b").replace(num_heads=4, num_kv_heads=2, d_model=64,
                                              d_ff=128, compute_dtype="float32",
                                              param_dtype="float32")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Runs WORKER_SCRIPT on 4 gloo ranks; returns each rank's results
    and JAX's unsharded losses on the same weights."""
    out = tmp_path_factory.mktemp("four_ranks")
    jcfg = spmd_config_jax()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np.savez(out / "weights.npz", **dict(jax_paths(jax.tree.map(np.asarray, jp))))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER_SCRIPT, str(r), "4",
                               str(out / "rdzv"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    logs = []
    try:
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

    opt = jopt.AdamW(jsched.constant_schedule(1e-3))
    state = {"params": jp, "opt_state": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jax_make_train_step(jcfg, opt, JaxStepConfig(remat="dots")))
    data = JaxSyntheticLMData(jcfg, 8, 32)
    jax_losses = []
    for s in range(5):
        state, m = step(state, {k: jnp.asarray(v) for k, v in data.batch(s).items()})
        jax_losses.append(float(m["loss"]))
    return ranks, jax_losses


def test_batch_layout_matches_jax(four_ranks):
    """A batch sharded over ("pod", "data") holds on rank r the rows JAX
    puts on device r (the mesh's row-major coordinate r on both sides);
    the tuple in the other order lays rows out differently in JAX, and
    the port refuses it."""
    ranks, _ = four_ranks
    r = subprocess.run([sys.executable, "-c", JAX_LAYOUT_SCRIPT], capture_output=True,
                       text=True, timeout=JOIN_TIMEOUT_S,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    jl = json.loads(r.stdout.strip().splitlines()[-1])
    for res in ranks:
        assert res["batch_rows"] == jl["pod_data"][str(res["rank"])]
        assert res["reversed_tuple"] == "refused"
    assert jl["data_pod"] != jl["pod_data"]


def test_int8_pod_mean_four_ranks(four_ranks):
    ranks, _ = four_ranks
    for res in ranks:
        pm = res["pod_mean"]
        assert pm["rel"] < 0.1, pm
        assert pm["rel2"] < pm["rel"], pm                  # error feedback helps
        # two syncs: the gradient leaf's sum is int8 on the wire, and its
        # scale's max and the loss's mean over the pods go in f32
        assert pm["sums"] == {"torch.int8": 2, "torch.float32": 2}, pm
        assert pm["maxes"] == {"torch.int8": 0, "torch.float32": 2}, pm
        assert pm["dtensor"]
        assert abs(pm["loss"] - pm["exact_loss"]) <= 1e-6 * pm["exact_loss"]
    assert len({json.dumps(r["pod_mean"]) for r in ranks}) == 1


def test_kernel_wrappers_dtensor_paths(four_ranks):
    """RMSNorm gathers the last dim (its batch stays split over data);
    flash gathers the sequence, keeps heads split where the GQA groups
    stay whole (4/2 over model=2) and replicates them where not (4/1)."""
    ranks, _ = four_ranks
    for res in ranks:
        assert res["seen"] == [
            ["rmsnorm", [2, 6, 8]],
            ["flash", [2, 8, 4, 16], [2, 8, 2, 16]],
            ["flash", [2, 8, 2, 16], [2, 8, 1, 16]],
            ["flash", [2, 8, 4, 16], [2, 8, 1, 16]]]
        assert res["launches"] == {"rmsnorm": 1, "flash": 3}
        assert res["rmsnorm_out_placements"] == ["S(0)", "R"]
        for name, errs in res["wrapper_errs"].items():
            assert max(errs) <= 1e-6, (name, errs)


def test_sharded_checkpoint_restores_bit_equal(four_ranks):
    """A checkpoint of the sharded state (every rank gathers, rank 0
    writes) restores on every rank bit-equal, each leaf a DTensor on the
    same mesh with the same placements, and bit-equal into the unsharded
    tree too; the JAX package's ``restore_checkpoint`` reads it bit-equal."""
    ranks, _ = four_ranks
    for res in ranks:
        ck = res["ckpt"]
        assert ck["steps"] == [5, 5]
        assert sum(c["dtensor"] for c in ck["leaves"]) > 0
        for c in ck["leaves"]:
            assert c["same_layout"] and c["bit_equal"] and c["plain_bit_equal"], c
    ck_dir = ranks[0]["ckpt"]["dir"]
    saved = np.load(os.path.join(os.path.dirname(ck_dir), "ckpt_state.npz"))
    like = {}
    for key in saved.files:
        node = like
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(())
    restored, step = jax_restore_checkpoint(ck_dir, like)
    assert step == 5
    got = dict(jax_paths(jax.tree.map(np.asarray, restored)))
    assert sorted(got) == sorted(saved.files)
    for key in saved.files:
        assert got[key].dtype == saved[key].dtype
        assert np.array_equal(got[key], saved[key]), key


def test_sharded_training_matches_unsharded_and_jax(four_ranks):
    ranks, jax_losses = four_ranks
    for res in ranks:
        assert res["mesh"] == [["data", "model"], [[0, 1], [2, 3]]]
        assert res["all_dtensor"]
        for got, plain, want in zip(res["losses_sharded"], res["losses_plain"], jax_losses):
            assert abs(got - plain) <= 1e-4 * abs(plain), (res["losses_sharded"], res["losses_plain"])
            assert abs(got - want) <= 1e-4 * abs(want), (res["losses_sharded"], jax_losses)
        assert res["losses_sharded"][-1] < res["losses_sharded"][0]


# ---------------------------------------------------------------------------
# One rank: every family under a 1 x 1 mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_1x1(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    yield DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["arctic-480b", "mamba2-780m", "hymba-1.5b",
                                  "internvl2-1b", "musicgen-medium"])
def test_forward_under_a_mesh_is_bit_equal(arch, mesh_1x1):
    """The logits and aux losses of ``forward`` on the 1 x 1 mesh (every
    parameter and batch tensor a DTensor) are those without it, bit for
    bit."""
    from repro_torch.data.pipeline import SyntheticLMData
    cfg = smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(cfg, 4, 32).batch(0).items()}
    want, want_aux = lm.forward(cfg, params, batch, "kernel")
    rules = tshard.ShardingRules(mesh=mesh_1x1)
    with tshard.use_rules(rules):
        sharded = tshard.distribute_tree(params, tshard.param_shardings(
            lm.param_specs(cfg), rules, lm.abstract_params(cfg)), mesh_1x1)
        got, aux = lm.forward(cfg, sharded, tshard.distribute_batch(batch, rules), "kernel")
    assert isinstance(got, torch.distributed.tensor.DTensor)
    assert torch.equal(got.full_tensor(), want)
    assert sorted(aux) == sorted(want_aux) == (
        ["load_balance", "router_z"] if cfg.num_experts else [])
    for name, v in aux.items():
        assert torch.equal(tshard.to_plain(v), want_aux[name]), name


def test_ssd_chunk_on_a_dtensor_equals_plain(mesh_1x1):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    b, nc, Q, N, H, P = 1, 2, 4, 4, 2, 4
    shapes = [(b, nc, Q, N), (b, nc, Q, N), (b, nc, Q, H, P), (b, nc, Q, H), (b, nc, Q, H)]
    plain = [torch.tensor(np.random.RandomState(i).randn(*s), dtype=torch.float32)
             for i, s in enumerate(shapes)]
    plain[4] = -plain[3].abs()
    ins = [distribute_tensor(t, mesh_1x1, [Replicate(), Replicate()]) for t in plain]
    for got, want in zip(ssd_chunk(*ins), ssd_chunk_ref(*plain)):
        assert isinstance(got, DTensor) and torch.equal(got.full_tensor(), want)
