"""Sharded prefill and decode on four gloo ranks, on the CPU.

Four ranks over gloo (each a ``python -c`` process, rendezvous through a
file in ``tmp_path``, one thread each, joined with a timeout of its own)
run WORKER_SCRIPT once: on a (2, 2) data x model mesh, under
``use_rules(ShardingRules(mesh=...))``, the smoke configs of
h2o-danube-1.8b (dense, a sliding window the prompt overruns, so the
prefill's cache is a rolled ring buffer), mamba2-780m (ssm), hymba-1.5b
(hybrid) and grok-1-314b (moe) in f32, from the JAX package's weights
through ``repro_torch.convert``, run ``lm.prefill`` on a batch of 4
prompts of 20 tokens and 4 greedy ``lm.decode_step``s, the parameters
placed by the rules, the prompt and tokens over the batch, the cache as
the JAX package's dry run places it (``cache_shardings``). The same
rank runs them without the rules too (the unsharded port), and the test
runs JAX's ``lm.prefill`` and ``lm.decode_step`` on the same weights:

* last-position logits within 1e-4 relative of both, every decode
  step's logits too;
* the primed cache and the cache after the decode steps within 1e-4
  relative of both, leaf by leaf;
* the greedy tokens of the 4 steps equal.

The worker takes the port's own weights (seed 0) when the directory has
no ``.npz`` of an arch: so it also runs without JAX.
"""

import json
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
from repro.models import lm as jlm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240
ARCHS = ("h2o-danube-1.8b", "mamba2-780m", "hymba-1.5b", "grok-1-314b")
BATCH, PROMPT, STEPS = 4, 20, 4
REL = 1e-4
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}

WORKER_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rdzv, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
runs = json.loads(sys.argv[5])

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm
from repro_torch.parallel.sharding import (ShardingRules, distribute_batch, distribute_tree,
                                           param_shardings, to_plain, use_rules)

dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))

def walk(fn, tree):
    if isinstance(tree, dict):
        return {k: walk(fn, v) for k, v in tree.items()}
    return fn(tree)

def weights(arch, cfg):
    path = f"{out_dir}/{arch}.npz"
    if not os.path.exists(path):
        return lm.init_params(cfg, 0, "cpu")
    w = np.load(path)
    tree = {}
    for key in w.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = w[key]
    return convert.params_from_jax(tree, "cpu")

def serve(cfg, params, prompt, steps, rules):
    with torch.no_grad(), use_rules(rules):
        place = lambda b: b
        if rules is not None:
            params = distribute_tree(params, param_shardings(
                lm.param_specs(cfg), rules, lm.abstract_params(cfg)), mesh)
            place = lambda b: distribute_batch(b, rules)
        logits, cache = lm.prefill(cfg, params, place({"tokens": prompt}),
                                   max_len=prompt.shape[1] + steps)
        out = {"prefill": to_plain(logits)[:, -1].tolist(),
               "cache": walk(lambda t: to_plain(t).tolist(), cache),
               "placements": walk(lambda t: [str(p) for p in t.placements]
                                  if isinstance(t, DTensor) else None, cache),
               "tokens": [], "decode": []}
        tok = torch.argmax(to_plain(logits)[:, -1], dim=-1)
        for _ in range(steps):
            out["tokens"].append(tok.tolist())
            batch = place({"tokens": tok[:, None].to(torch.int32)})
            logits, cache = lm.decode_step(cfg, params, batch["tokens"], cache)
            last = to_plain(logits)[:, -1]
            out["decode"].append(last.tolist())
            tok = torch.argmax(last, dim=-1)
        out["tokens"].append(tok.tolist())
        out["final_cache"] = walk(lambda t: to_plain(t).tolist(), cache)
    return out

res = {"sharded": {}, "plain": {}}
for i, (arch, prompt, steps) in enumerate(runs):
    cfg = smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    params = weights(arch, cfg)
    prompt = torch.tensor(prompt, dtype=torch.int32)
    res["sharded"][arch] = serve(cfg, params, prompt, steps, ShardingRules(mesh=mesh))
    if i % world == rank:          # the unsharded runs, spread over the ranks
        res["plain"][arch] = serve(cfg, params, prompt, steps, None)
with open(f"{out_dir}/rank{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), np.asarray(leaf)) for path, leaf in flat]


def prompt_of(cfg):
    return np.random.RandomState(1).randint(0, cfg.vocab_size, size=(BATCH, PROMPT))


def jax_serve(jcfg, jp, prompt):
    """JAX's prefill and greedy decode steps on the same weights."""
    logits, cache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                                max_len=PROMPT + STEPS)
    out = {"prefill": np.asarray(logits[:, -1]), "cache": jax.tree.map(np.asarray, cache),
           "tokens": [], "decode": []}
    tok = jnp.argmax(logits[:, -1], axis=-1)
    for _ in range(STEPS):
        out["tokens"].append(np.asarray(tok).tolist())
        logits, cache = jlm.decode_step(jcfg, jp, tok[:, None].astype(jnp.int32), cache)
        out["decode"].append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1)
    out["tokens"].append(np.asarray(tok).tolist())
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """WORKER_SCRIPT's results on 4 gloo ranks, and JAX's (taken while the
    ranks run) on the same weights and prompts."""
    out = tmp_path_factory.mktemp("serve_mesh")
    jcfgs, jparams, runs = {}, {}, []
    for arch in ARCHS:
        jcfgs[arch] = jax_smoke_config(arch).replace(**F32)
        jparams[arch] = jlm.init_params(jcfgs[arch], jax.random.PRNGKey(0))
        np.savez(out / f"{arch}.npz", **dict(jax_paths(jparams[arch])))
        runs.append([arch, prompt_of(jcfgs[arch]).tolist(), STEPS])
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER_SCRIPT, str(r), "4",
                               str(out / "rdzv"), str(out), json.dumps(runs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(4)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    logs = []
    try:
        want = {a: jax_serve(jcfgs[a], jparams[a], prompt_of(jcfgs[a])) for a in ARCHS}
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


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_logits_match_jax_and_unsharded(four_ranks, arch):
    ranks, plain, want = four_ranks
    for res in ranks:
        got = res["sharded"][arch]
        assert rel(got["prefill"], plain[arch]["prefill"]) <= REL
        assert rel(got["prefill"], want[arch]["prefill"]) <= REL
        for g, p, j in zip(got["decode"], plain[arch]["decode"], want[arch]["decode"]):
            assert rel(g, p) <= REL and rel(g, j) <= REL


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_cache_matches_jax_and_unsharded(four_ranks, arch):
    """The primed cache and the cache after the decode steps, leaf by
    leaf; the sharded one placed as the dry run places it: the KV cache
    and a 5-d SSD state over (batch: data, dim 2: model), the conv window
    over the batch, the clock replicated."""
    ranks, plain, want = four_ranks
    for res in ranks:
        got = res["sharded"][arch]
        for key in ("cache", "final_cache"):
            ours = dict(leaves(got[key]))
            theirs = dict(leaves(plain[arch][key]))
            jx = dict(leaves(want[arch][key]))
            assert set(ours) == set(theirs) == set(jx)
            for name in ours:
                assert rel(ours[name], theirs[name]) <= REL, (key, name)
                assert rel(ours[name], jx[name]) <= REL, (key, name)
        placed = dict(leaves(got["placements"]))
        assert placed["/pos"] == ["R", "R"]
        for name, pl in placed.items():
            if name.endswith(("/k", "/v", "/state")):
                assert pl == ["S(1)", "S(2)"], (name, pl)
            elif name.endswith("/conv"):
                assert pl == ["S(1)", "R"], (name, pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_greedy_tokens_equal_jax_and_unsharded(four_ranks, arch):
    ranks, plain, want = four_ranks
    for res in ranks:
        assert res["sharded"][arch]["tokens"] == plain[arch]["tokens"] == want[arch]["tokens"]
        assert len(res["sharded"][arch]["tokens"]) == STEPS + 1
