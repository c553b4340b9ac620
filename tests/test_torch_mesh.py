"""The LM stack on a device mesh in the port (repro_torch.launch.mesh,
models.sharding, the moe layer's expert parallelism, train.step on a mesh,
distributed.compression, checkpoint re-sharding, launch.train as N
processes) against the JAX package at the same mesh shape, on the CPU.

The port runs as 4 gloo processes, spawned once for the module with
``OMP_NUM_THREADS=1`` (each is this file run as a script, importing torch
and repro_torch only); the JAX package runs in a subprocess with 4 host
devices (``--xla_force_host_platform_device_count``, as
``tests/test_multidevice.py`` does).  Both start from JAX's
``init_train_state(PRNGKey(0))`` and the same ``SyntheticLM`` batches (8
x 32).  The JAX side writes each case when it is done and the workers
take it up as it comes.  JAX's steps are its jitted gradient, its pod
mean where asked and its jitted ``adamw_update`` (``make_train_step``'s
composition at one microbatch); every JAX ``router_topk`` call hands its
global top-k indices to a debug callback, and each rank's routing is held
to its rows of them (``moe.log_routing(replay=...)``, as
``tests/test_torch_train_moe.py`` holds one card's: the first step at
``moe.NEAR_TIE_ULPS``, later steps at ``STEP_TIE_ULPS``).

Cases (mesh, batch axes):
* reduced smollm-360m with ``seq_parallel='full'``, (2, 2);
* reduced olmoe-1b-7b, ``moe_impl`` 'psum' (``_ep_shard`` at n_model 2)
  and 'a2a' with ``capacity_factor`` 2.0 (``_ep_a2a_shard``), (2, 2);
* reduced deepseek-v2, (2, 2);
* reduced olmoe, the pod mesh (2, 1, 2) with ``compress_pod_grads``,
  batch over ("pod", "data"); then its checkpoint restored onto the
  one-pod mesh (2, 2) (the elastic downsize) and one more step.

Contracts:
* layout: every parameter leaf's shard on each rank is the slice JAX's
  ``NamedSharding`` gives the device at that mesh coordinate;
* two steps' losses rtol 1e-3; the first step's gradients (gathered from
  the ranks' shards) within ``GRAD_ULPS`` (8) bf16 ulps of each leaf's
  largest magnitude, cosine >= 0.999 — with ``compress_pod_grads`` the
  gradients after the pod mean;
* the dense case against the port's one-process run too (the first loss
  rtol 1e-5, the steps' rtol 1e-3 — AdamW's first update turns a gradient
  element's sign, where the two runs' sums differ, into +-lr — and the
  gradients within ``GRAD_ULPS``: the embedding's gradient adds
  each token id's bf16 cotangents in bf16, and split over the data ranks
  those sums round apart — 4.05 ulps measured on the CPU);
* the elastic restore: the restored shards equal the saved state's bit for
  bit, the next step's loss rtol 1e-3 of JAX's; a JAX checkpoint restores
  into a sharded port state leaf for leaf;
* ``init_train_state(mesh=)`` gives each rank the shards of the state it
  draws on one process, leaf for leaf;
* ``launch.train --model-parallel 2`` runs as 4 processes under
  ``torchrun``.

Serving on the mesh (the same spawned workers and JAX subprocess): reduced
smollm-360m, olmoe-1b-7b ('psum' and 'a2a' with ``capacity_factor`` 2.0),
zamba2-1.2b and deepseek-v2 at (2, 2), from JAX's ``init_params(PRNGKey
(0))``, a prompt batch of 4 x 32 and 4 decode steps, against JAX's jitted
``make_prefill_step`` and ``make_decode_step`` with ``mesh=`` at (2, 2)
(JAX generates greedily; the port is fed JAX's tokens, its routing held
to JAX's rows at ``SERVE_TIE_ULPS``):
* each rank's prefill and decode logits within ``MODEL_ULPS`` (4) bf16
  ulps of the largest magnitude of JAX's (zamba2's and deepseek's decode:
  ``DRIFT_ULPS``, 8), and its greedy tokens JAX's wherever JAX's top-2
  margin exceeds twice that bound;
* each rank's decode cache shard (after the prefill and the 4 steps) the
  slice JAX's ``NamedSharding`` of ``cache_specs`` gives its coordinate,
  within the same bounds;
* each rank's logits and cache against the port's one-process run on
  its rows, within ``MODEL_ULPS`` (every case but 'a2a', whose drops
  follow each model rank's chunk of the sequence);
* ``launch.serve --model-parallel 2`` runs as 4 processes under
  ``torchrun``.

The shape-only trace prices the real program: on every rank the
``(op, bytes, group size)`` records of reduced olmoe's train step at (2,
2) ('psum') equal those of the same step traced on ``meta`` for that rank
of ``ShapeMesh((2, 2))``.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

WORLD = 4
B, S = 8, 32
GRAD_ULPS = 8
LOSS_RTOL = 1e-3
MESH_TIE_ULPS = 4
STEP_TIE_ULPS = 16
MODEL_ULPS = 4
SB, SS, ST = 4, 32, 4          # serving: batch, prompt, decode steps
# JAX's own (2, 2) serving program is not its (1, 1) program: the same
# weights and tokens (capacity factor 8, so no assignment is dropped
# either way) give decode logits up to 4.19 bf16 ulps of their largest
# magnitude apart on reduced zamba2-1.2b (its cache 5.17), 5.8-9.3 on
# reduced deepseek-v2's prefill and first steps (2.7 on smollm), and
# router logits move as far.  So the port's routing is held to JAX's at
# (2, 2) within SERVE_TIE_ULPS, and zamba2's and deepseek's decode logits
# and cache within DRIFT_ULPS (4.4 and 5.0 measured), the others' within
# MODEL_ULPS.  The port's (2, 2) program is its one-process program on
# each rank's rows (test_serving_matches_one_process, within MODEL_ULPS;
# 0 ulps measured), so the excess is JAX's (2, 2) program's drift
SERVE_TIE_ULPS = 8
DRIFT_ULPS = 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CASES = [
    dict(name="smollm_sp", arch="smollm_360m", over={"seq_parallel": "full"},
         shape=[2, 2], axes=["data", "model"], dp=["data"], compress=False),
    dict(name="olmoe_psum", arch="olmoe_1b_7b", over={},
         shape=[2, 2], axes=["data", "model"], dp=["data"], compress=False),
    dict(name="olmoe_a2a", arch="olmoe_1b_7b",
         over={"moe_impl": "a2a", "capacity_factor": 2.0},
         shape=[2, 2], axes=["data", "model"], dp=["data"], compress=False),
    dict(name="deepseek", arch="deepseek_v2_236b", over={},
         shape=[2, 2], axes=["data", "model"], dp=["data"], compress=False),
    dict(name="olmoe_pod", arch="olmoe_1b_7b", over={},
         shape=[2, 1, 2], axes=["pod", "data", "model"],
         dp=["pod", "data"], compress=True, elastic=True),
]
NAMES = [c["name"] for c in CASES]
SERVE_CASES = [
    dict(name="serve_smollm", arch="smollm_360m", over={}),
    dict(name="serve_olmoe_psum", arch="olmoe_1b_7b", over={}),
    dict(name="serve_olmoe_a2a", arch="olmoe_1b_7b",
         over={"moe_impl": "a2a", "capacity_factor": 2.0}),
    dict(name="serve_zamba2", arch="zamba2_1_2b", over={},
         decode_ulps=DRIFT_ULPS),
    dict(name="serve_deepseek", arch="deepseek_v2_236b", over={},
         decode_ulps=DRIFT_ULPS),
]
SERVE_NAMES = [c["name"] for c in SERVE_CASES]
# the cases whose (2, 2) program is the one-process program on each rank's
# rows: a2a drops over each model rank's chunk of the sequence, which no
# one-process run of those rows reproduces
ONE_PROCESS_NAMES = [n for n in SERVE_NAMES if n != "serve_olmoe_a2a"]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, functools, json, pickle
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distributed import checkpoint as ckpt
from repro.distributed import compression
from repro.launch.mesh import compat_mesh
from repro.models import moe as jmoe
from repro.models import sharding as shd
from repro.train import optimizer as jopt
from repro.train.step import TrainState, init_train_state, make_loss_fn

out, cases, opt_kw, B, S = (sys.argv[1], json.loads(sys.argv[2]),
                            json.loads(sys.argv[3]), int(sys.argv[4]),
                            int(sys.argv[5]))
serve_cases, (SB, SS, ST) = json.loads(sys.argv[6]), json.loads(sys.argv[7])
ROUTES = []
orig = jmoe.router_topk
def wrapped(params, x, cfg):
    w, i, a = orig(params, x, cfg)
    jax.debug.callback(lambda t: ROUTES.append(np.array(t)), i)
    return w, i, a
jmoe.router_topk = wrapped

def forward_routes(cfg):
    # the forward's calls come first, then the remat rerun's
    jax.effects_barrier()
    n = cfg.n_layers - cfg.first_dense if cfg.n_experts else 0
    got = list(ROUTES)
    ROUTES.clear()
    assert len(got) == 2 * n, (len(got), n)
    return got[:n]

np_tree = lambda t: jax.tree.map(np.asarray, t)
flat = lambda t: [(jax.tree_util.keystr(p), np.asarray(x))
                  for p, x in jax.tree_util.tree_flatten_with_path(t)[0]]

def shardings(cfg, state, mesh):
    ps = shd.to_shardings(shd.param_specs(cfg, state.params, mesh), mesh)
    return TrainState(ps, jopt.OptState(m=ps, v=ps,
                                        step=NamedSharding(mesh, P())))

def layout(params, mesh):
    coords = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    out = {}
    for key, leaf in [(jax.tree_util.keystr(p), x) for p, x in
                      jax.tree_util.tree_flatten_with_path(params)[0]]:
        m = leaf.sharding.devices_indices_map(leaf.shape)
        out[key] = {coords[d.id]: [[s.start or 0, leaf.shape[k]
                                    if s.stop is None else s.stop]
                                   for k, s in enumerate(idx)]
                    for d, idx in m.items()}
    return out

grad_fns, inits = {}, {}
def grad_fn(cfg, mesh, dp):
    key = (cfg, tuple(mesh.shape.items()), dp)
    if key not in grad_fns:
        grad_fns[key] = jax.jit(jax.value_and_grad(
            make_loss_fn(cfg, mesh=mesh, dp=dp), has_aux=True))
    return grad_fns[key]

adamw = jax.jit(functools.partial(jopt.adamw_update,
                                  jopt.OptimizerConfig(**opt_kw)))

def steps(cfg, mesh, dp, state, batches, compress):
    losses, routes, first = [], [], None
    for b in batches:
        (loss, _), g = grad_fn(cfg, mesh, dp)(state.params, b)
        r = forward_routes(cfg)
        gc = g
        if compress:
            gc = jax.jit(functools.partial(compression.pod_compressed_mean,
                                           mesh=mesh))(g)
        if first is None:
            first = (flat(gc), flat(g))
        params, opt, _ = adamw(state.params, gc, state.opt)
        state = TrainState(params, opt)
        losses.append(float(loss))
        routes.append(r)
    return state, losses, routes, first

for case in cases:
    cfg = dataclasses.replace(get_reduced(case["arch"]), **case["over"])
    if case["arch"] not in inits:
        inits[case["arch"]] = jax.jit(init_train_state, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
    state0 = inits[case["arch"]]
    data = SyntheticLM(DataConfig(seq_len=S, global_batch=B,
                                  vocab=cfg.vocab, seed=0))
    batches = [data.batch_at(i) for i in range(2)]
    mesh = compat_mesh(tuple(case["shape"]), tuple(case["axes"]))
    dp = tuple(case["dp"])
    res = {"state": {"params": np_tree(state0.params),
                     "m": np_tree(state0.opt.m), "v": np_tree(state0.opt.v),
                     "step": int(state0.opt.step)},
           "batches": batches}
    with mesh:
        state = jax.device_put(state0, shardings(cfg, state0, mesh))
        res["layout"] = layout(state.params, mesh)
        state, res["losses"], res["routes"], (res["grads"],
                                              res["grads_exact"]) = steps(
            cfg, mesh, dp, state, batches, case["compress"])
    if case.get("elastic"):
        d = os.path.join(out, "jax_ckpt", "step_2")
        ckpt.save_checkpoint(d, state, 2)
        small = compat_mesh((2, 2), ("data", "model"))
        with small:
            fresh = jax.jit(init_train_state, static_argnums=0)(
                cfg, jax.random.PRNGKey(1))
            restored, n = ckpt.restore_checkpoint(
                d, fresh, shardings=shardings(cfg, fresh, small))
            _, loss, routes, _ = steps(cfg, small, ("data",), restored,
                                       [data.batch_at(2)], False)
        res["elastic"] = {"ckpt": d, "step": n, "loss": loss[0],
                          "routes": routes[0], "batch": data.batch_at(2)}
    with open(os.path.join(out, case["name"] + ".tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(out, case["name"] + ".tmp"),
               os.path.join(out, case["name"] + ".pkl"))
import jax.numpy as jnp
from repro.models import transformer as jtr
from repro.serve.step import (_load_prefill, make_decode_step,
                              make_prefill_step)

def serve_routes(cfg):
    jax.effects_barrier()
    n = cfg.n_layers - cfg.first_dense if cfg.n_experts else 0
    got = list(ROUTES)
    ROUTES.clear()
    assert len(got) == n, (len(got), n)
    return got

def cache_layout(cache, cfg, mesh):
    coords = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    specs = jax.tree.leaves(shd.cache_specs(cfg, cache, mesh, SB),
                            is_leaf=lambda x: isinstance(x, P))
    out = []
    for leaf, spec in zip(jax.tree.leaves(cache), specs):
        m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
        out.append((np.asarray(leaf.astype(jnp.float32)),
                    {coords[d.id]: [[sl.start or 0, leaf.shape[k]
                                     if sl.stop is None else sl.stop]
                                    for k, sl in enumerate(idx)]
                     for d, idx in m.items()}))
    return out

for case in serve_cases:
    cfg = dataclasses.replace(get_reduced(case["arch"]), **case["over"])
    params = jax.jit(jtr.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (SB, SS)).astype(np.int32)
    mesh = compat_mesh((2, 2), ("data", "model"))
    ROUTES.clear()
    with mesh:
        ps = jax.device_put(params, shd.to_shardings(
            shd.param_specs(cfg, params, mesh), mesh))
        tok, logits, pfc = jax.jit(make_prefill_step(
            cfg, mesh=mesh, dp=("data",)))(ps, {"tokens": tokens})
        routes = [serve_routes(cfg)]
        cache = _load_prefill(cfg, jtr.init_cache(cfg, SB, SS + ST), pfc, SS)
        dec = jax.jit(make_decode_step(cfg, mesh=mesh, dp=("data",)))
        feed, step_logits = [np.asarray(tok)], []
        for t in range(ST):
            tok, lg, cache = dec(ps, tok[:, None], cache,
                                 jnp.array(SS + t, jnp.int32))
            routes.append(serve_routes(cfg))
            step_logits.append(np.asarray(lg))
            feed.append(np.asarray(tok))
        res = {"params": np_tree(params), "tokens": tokens,
               "logits": np.asarray(logits),
               "step_logits": np.stack(step_logits, 1),
               "feed": np.stack(feed, 1), "routes": routes,
               "cache": cache_layout(cache, cfg, mesh)}
    with open(os.path.join(out, case["name"] + ".tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(out, case["name"] + ".tmp"),
               os.path.join(out, case["name"] + ".pkl"))
print("jax done")
"""


# ---------------------------------------------------------------------------
# The port's side: one rank (this file run as a script)
# ---------------------------------------------------------------------------
def _wait_for(path, timeout_s=600.0):
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def _port_state(res, cfg):
    from types import SimpleNamespace
    from repro_torch.models.convert import train_state_from_jax
    st = res["state"]
    return train_state_from_jax(SimpleNamespace(
        params=st["params"], opt=SimpleNamespace(m=st["m"], v=st["v"],
                                                 step=st["step"])), cfg,
        "cpu")


def _flat_keys(tree, prefix=""):
    """[(JAX keystr, leaf)] of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat_keys(tree[k], f"{prefix}['{k}']")]
    return [(prefix, tree)]


def _rank_run(rank, out):
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import moe
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    def local(routes, mesh, dp):
        i, n = tstep.dp_index(mesh, dp)
        b = B // n
        return [r[i * b:(i + 1) * b] for r in routes]

    def gathered(tree, specs, mesh):
        return shd.map_specs(
            lambda spec, x: shd.gather(x, spec, mesh, differentiable=False)
            .numpy(), specs, tree)

    def train(cfg, state, mesh, dp, batches, routes, compress, first_tie):
        step = tstep.make_train_step(
            cfg, topt.OptimizerConfig(**OPT),
            tstep.StepConfig(compress_pod_grads=compress), mesh, tuple(dp))
        losses = []
        for i, (b, r) in enumerate(zip(batches, routes)):
            with moe.log_routing(replay=local(r, mesh, dp), tie_ulps=(
                    first_tie if i == 0 else STEP_TIE_ULPS)):
                state, m = step(state, to_device(b, "cpu"))
            losses.append(float(m["loss"]))
        return state, losses

    for case in CASES:
        res = _wait_for(os.path.join(out, case["name"] + ".pkl"))
        cfg = dataclasses.replace(get_reduced(case["arch"]), **case["over"])
        mesh = compat_mesh(case["shape"], case["axes"], "cpu")
        dp = tuple(case["dp"])
        specs = tstep.state_specs(cfg, mesh)
        state = tstep.shard_train_state(_port_state(res, cfg), cfg, mesh)
        drawn = tstep.init_train_state(cfg, 3, "cpu", mesh)
        cut = tstep.shard_train_state(tstep.init_train_state(cfg, 3, "cpu"),
                                      cfg, mesh)
        batch0 = to_device(res["batches"][0], "cpu")
        replay = local(res["routes"][0], mesh, dp)

        def grads_of(compress):
            grad_fn = tstep.make_grad_fn(
                cfg, tstep.StepConfig(compress_pod_grads=compress), mesh, dp)
            with moe.log_routing(replay=replay, tie_ulps=MESH_TIE_ULPS):
                return grad_fn(state.params, batch0)

        loss, _, grads, norm = grads_of(False)
        mine = {"coord": list(mesh.get_coordinate()),
                "init_sharded": all(torch.equal(a, b) for a, b in zip(
                    topt.tree_leaves(drawn), topt.tree_leaves(cut)))}
        del drawn, cut
        if case["compress"]:
            with capturing_pod_inputs() as pod_in:
                loss, _, cgrads, norm = grads_of(True)
            mine["compress"] = check_pod_mean(mesh, pod_in, grads, cgrads)
            mine["grads_exact"] = _flat_keys(gathered(grads, specs.params,
                                                      mesh))
            grads = cgrads
        grads = gathered(grads, specs.params, mesh)
        shapes = transformer.init_params(cfg, device="meta", masters=True)
        layout = {key: [[s.start, s.stop] for s in
                        shd.shard_slices(spec, leaf.shape, mesh)]
                  for (key, spec), (_, leaf) in zip(
                      _flat_keys(specs.params), _flat_keys(shapes))}
        if case["name"] == "olmoe_psum":
            mine["records"] = _records_check(rank, cfg, mesh, dp, state,
                                             batch0, replay)
        state, losses = train(cfg, state, mesh, dp, res["batches"],
                              res["routes"], case["compress"],
                              MESH_TIE_ULPS)
        mine["layout"] = layout
        if case.get("elastic"):
            mine["elastic"] = _elastic(rank, out, cfg, mesh, state, res,
                                       train)
        if rank == 0:
            mine.update(loss=float(loss), losses=losses, norm=float(norm),
                        grads=_flat_keys(grads))
        with open(os.path.join(out, f"{case['name']}.rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(mine, f)
    for case in SERVE_CASES:
        mine = _serve_run(rank, case, _wait_for(os.path.join(
            out, case["name"] + ".pkl")))
        with open(os.path.join(out, f"{case['name']}.rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(mine, f)
    dist.barrier()


def _records_check(rank, cfg, mesh, dp, state, batch, replay):
    """(the collectives of one train step on this rank, those of the step
    traced on meta for this rank of ShapeMesh((2, 2)))."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import moe
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    opt = topt.OptimizerConfig(**OPT)
    with coll.recording() as real, moe.log_routing(
            replay=replay, tie_ulps=MESH_TIE_ULPS):
        tstep.make_train_step(cfg, opt, mesh=mesh, dp=dp)(state, batch)
    smesh = ShapeMesh((2, 2), ("data", "model"), rank)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}
    with coll.recording() as shape_only:
        tstep.make_train_step(cfg, opt, mesh=smesh, dp=dp)(
            tstep.init_train_state(cfg, 0, "meta", smesh), meta)
    return {"real": real, "shape_only": shape_only}


def _serve_run(rank, case, res):
    """One rank's serving at (2, 2) from JAX's parameters: the prefill and
    ST decode steps fed JAX's tokens, routing replayed from JAX's rows;
    the logits of the rank's rows and its cache shards (the dense case:
    the one-process run's logits too)."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import moe
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve.step import (_load_prefill, make_decode_step,
                                        make_prefill_step)
    cfg = dataclasses.replace(get_reduced(case["arch"]), **case["over"])
    mesh = compat_mesh((2, 2), ("data", "model"), "cpu")
    dp = ("data",)
    whole = params_from_jax(res["params"], cfg, "cpu")
    params = shd.map_specs(lambda sp, x: shd.shard(x, sp, mesh),
                           shd.model_param_specs(cfg, mesh), whole)
    rows = shd.shard_slices(shd.P(shd.batch_axis(mesh, SB, dp)), (SB,),
                            mesh)[0]
    local = lambda routes: [r[rows] for r in routes]
    tokens = torch.from_numpy(res["tokens"])
    with moe.log_routing(replay=local(res["routes"][0]),
                         tie_ulps=SERVE_TIE_ULPS):
        _, logits, pfc = make_prefill_step(cfg, mesh, dp)(
            params, {"tokens": tokens})
    cache = _load_prefill(cfg, transformer.init_cache(
        cfg, SB, SS + ST, "cpu", mesh), pfc, SS)
    decode = make_decode_step(cfg, mesh, dp)
    steps = []
    for t in range(ST):
        feed = torch.from_numpy(res["feed"][:, t])[:, None]
        with moe.log_routing(replay=local(res["routes"][t + 1]),
                             tie_ulps=SERVE_TIE_ULPS):
            _, lg, cache = decode(params, feed, cache, SS + t)
        steps.append(lg)
    mine = {"coord": list(mesh.get_coordinate()),
            "rows": [rows.start, rows.stop], "logits": logits.numpy(),
            "step_logits": torch.stack(steps, 1).numpy(),
            "cache": [a.float().numpy() for k in sorted(cache)
                      for a in cache[k]]}
    if case["name"] in ONE_PROCESS_NAMES:
        mine["one_process"] = _serve_one_process(cfg, whole, tokens[rows],
                                                 res, local)
    return mine


def _serve_one_process(cfg, params, tokens, res, local):
    """The port's one-process run of ``_serve_run``'s program on the
    rank's rows from the whole parameters: the prefill's and the ST
    decode steps' logits and the whole cache of those rows, routing
    replayed from JAX's rows (``local``)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer
    from repro_torch.serve.step import _load_prefill
    B = tokens.shape[0]
    with moe.log_routing(replay=local(res["routes"][0]),
                         tie_ulps=SERVE_TIE_ULPS):
        logits, pfc, _ = transformer.prefill(cfg, params, {"tokens": tokens})
    cache = _load_prefill(cfg, transformer.init_cache(cfg, B, SS + ST,
                                                      "cpu"), pfc, SS)
    steps = []
    for t in range(ST):
        feed = torch.from_numpy(local([res["feed"][:, t]])[0])[:, None]
        with moe.log_routing(replay=local(res["routes"][t + 1]),
                             tie_ulps=SERVE_TIE_ULPS):
            lg, cache = transformer.decode_step(cfg, params, feed, cache,
                                                SS + t)
        steps.append(lg)
    return {"logits": logits.numpy(),
            "step_logits": torch.stack(steps, 1).numpy(),
            "cache": [a.float().numpy() for k in sorted(cache)
                      for a in cache[k]]}


def _elastic(rank, out, cfg, mesh, state, res, train):
    """The pod mesh's state saved, restored onto (2, 2), one step; JAX's
    checkpoint restored there too."""
    import torch.distributed as dist
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import tree_leaves
    d = os.path.join(out, "port_ckpt", "step_2")
    ckpt.save_checkpoint(d, state, 2, rank,
                         tstep.state_shardings(cfg, mesh))
    whole = tstep.gather_train_state(state, cfg, mesh)
    dist.barrier()
    small = compat_mesh((2, 2), ("data", "model"), "cpu")
    sh = tstep.state_shardings(cfg, small)
    like = tstep.init_train_state(cfg, seed=1, device="cpu", mesh=small)
    restored, n = ckpt.restore_checkpoint(d, like, sh)
    want = tstep.shard_train_state(whole, cfg, small)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(want)))
    el = res["elastic"]
    _, loss = train(cfg, restored, small, ("data",), [el["batch"]],
                    [el["routes"]], False, STEP_TIE_ULPS)
    jrest, jn = ckpt.restore_checkpoint(el["ckpt"], like, sh)
    jwhole = tstep.gather_train_state(jrest, cfg, small)
    with np.load(os.path.join(el["ckpt"], "shard_0.npz")) as z:
        jax_leaves = {k: z[k] for k in z.files}
    jax_equal = all(np.array_equal(jax_leaves[k], v.numpy())
                    for k, v in ckpt._flatten(jwhole))
    return {"step": n, "same": same, "loss": loss[0], "jax_step": jn,
            "jax_equal": jax_equal, "n_leaves": len(jax_leaves)}


class capturing_pod_inputs:
    """Within the block, every input of the port's
    ``compression.compressed_psum_mean`` (a rank's shard of a pod's
    gradient leaf) is kept, in call order; the port is observed, not
    changed."""

    def __enter__(self):
        from repro_torch.distributed import compression
        self.mod, self.orig, self.got = (compression,
                                         compression.compressed_psum_mean, [])

        def spy(x, group):
            self.got.append(x.clone())
            return self.orig(x, group)
        compression.compressed_psum_mean = spy
        return self.got

    def __exit__(self, *exc):
        self.mod.compressed_psum_mean = self.orig


def check_pod_mean(mesh, pod_in, exact, compressed):
    """On this rank: (the pod mean equals the mean over the pod of each
    member's dequantized int8 payload, bit for bit; each compressed
    element lies within half a quantization step of the exact gradient,
    the widest of the pod members' steps)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import (dequantize_int8,
                                                     quantize_int8)
    from repro_torch.launch.mesh import axis_group
    from repro_torch.train.optimizer import tree_leaves
    group = axis_group(mesh, "pod")
    body, within = True, True
    for x, g, c in zip(pod_in, tree_leaves(exact), tree_leaves(compressed)):
        xs = coll.all_gather(x[None], 0, group)
        parts = [quantize_int8(xp) for xp in xs]
        want = sum(dequantize_int8(q, sc) for q, sc in parts) / len(parts)
        body &= torch.equal(want, c)
        half = max(float(sc) for _, sc in parts) / 2
        within &= bool(((c - g).abs() <= half * (1 + 1e-5) + 1e-12).all())
    return {"body": body, "within": within, "n": len(pod_in)}


def worker_main(argv):
    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _rank_run(rank, out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process: both sides run once per module
# ---------------------------------------------------------------------------
def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    jlog = open(os.path.join(out, "jax.log"), "w")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, out, json.dumps(CASES),
         json.dumps(OPT), str(B), str(S), json.dumps(SERVE_CASES),
         json.dumps([SB, SS, ST])], env=env, stdout=jlog,
        stderr=subprocess.STDOUT)]
    port = _free_port()
    logs = [jlog]
    for rank in range(WORLD):
        logs.append(open(os.path.join(out, f"rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             out], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    names = ["jax"] + [f"rank{r}" for r in range(WORLD)]
    # the first to fail, not one this fixture killed after it
    for name, p in sorted(zip(names, procs),
                          key=lambda np_: np_[1].returncode == -9):
        if p.returncode != 0:
            with open(os.path.join(out, f"{name}.log")) as f:
                tail = f.read()[-3000:]
            pytest.fail(f"{name} exited with {p.returncode}:\n{tail}")
    return out


def load(out, name, who):
    with open(os.path.join(out, f"{name}.{who}.pkl" if who != "jax"
                           else f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def assert_grad_close(got, ref, ulps, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    m = np.abs(ref).max()
    if m == 0:
        assert not got.any(), what
        return
    gap = np.abs(got - ref).max()
    assert gap <= ulps * 2.0 ** -8 * m, \
        f"{what}: {gap / (2.0 ** -8 * m):.2f} bf16 ulps of max |g|"
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.999, f"{what}: cosine {cos:.6f}"


@pytest.mark.parametrize("name", NAMES)
def test_layout_matches_jax(runs, name):
    j = load(runs, name, "jax")
    for rank in range(WORLD):
        mine = load(runs, name, f"rank{rank}")
        coord = tuple(mine["coord"])
        assert set(mine["layout"]) == set(j["layout"])
        for key, slices in mine["layout"].items():
            assert slices == j["layout"][key][coord], (rank, key)


@pytest.mark.parametrize("name", NAMES)
def test_losses_and_grads_match_jax(runs, name):
    """With compress_pod_grads the exact gradients (the port's reduced in
    f32 over every axis) are held to JAX's before its pod mean; the pod
    mean itself in test_pod_mean."""
    j, mine = load(runs, name, "jax"), load(runs, name, "rank0")
    np.testing.assert_allclose(mine["loss"], j["losses"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(mine["losses"], j["losses"], rtol=LOSS_RTOL)
    got = mine.get("grads_exact", mine["grads"])
    assert [k for k, _ in got] == [k for k, _ in j["grads_exact"]]
    for (key, g), (_, want) in zip(got, j["grads_exact"]):
        assert_grad_close(g, want, GRAD_ULPS, f"{name} {key}")


def np_round_trip(x):
    """JAX's ``dequantize_int8(*quantize_int8(x))`` in numpy f32."""
    x = np.asarray(x, np.float32)
    scale = np.maximum(np.abs(x).max(), np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q.astype(np.float32) * scale


def test_pod_mean(runs):
    """The pod mesh (2, 1, 2) with compress_pod_grads.  The port: each
    rank's pod mean is the mean of the pod members' dequantized int8
    payloads bit for bit, within half a quantization step of the exact
    gradient.  The JAX package: its pod mean is the int8 round trip of the
    gradient already reduced over every axis (the fault ROADMAP Queue 3
    logs), bit for bit."""
    j = load(runs, "olmoe_pod", "jax")
    for rank in range(WORLD):
        c = load(runs, "olmoe_pod", f"rank{rank}")["compress"]
        assert c["body"] and c["within"] and c["n"] == len(j["grads"]), rank
    for (key, got), (_, exact) in zip(j["grads"], j["grads_exact"]):
        assert np.array_equal(got, np_round_trip(exact)), key



def test_dense_matches_one_process(runs):
    """Reduced smollm on (2, 2) against the port's one-process run from
    the same state and batches."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    j, mine = load(runs, "smollm_sp", "jax"), load(runs, "smollm_sp", "rank0")
    cfg = dataclasses.replace(get_reduced("smollm_360m"), **CASES[0]["over"])
    state = _port_state(j, cfg)
    batches = [to_device(b, "cpu") for b in j["batches"]]
    loss, _, grads = tstep.value_and_grad(tstep.make_loss_fn(cfg),
                                          state.params, batches[0])
    np.testing.assert_allclose(mine["loss"], float(loss), rtol=1e-5)
    for (key, g), (_, t) in zip(mine["grads"], _flat_keys(grads)):
        assert_grad_close(g, t.numpy(), GRAD_ULPS, f"smollm {key}")
    step = tstep.make_train_step(cfg, topt.OptimizerConfig(**OPT))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(mine["losses"], losses, rtol=LOSS_RTOL)


def test_elastic_restore_continues_training(runs):
    """The pod mesh's checkpoint (gathered, leaf for leaf the JAX layout)
    restored onto the one-pod mesh (2, 2): every rank's shards equal the
    saved state's bit for bit, and the next step's loss is JAX's (which
    restored its own checkpoint the same way) within rtol 1e-3; JAX's
    checkpoint restores into the port's sharded state leaf for leaf."""
    j = load(runs, "olmoe_pod", "jax")["elastic"]
    assert j["step"] == 2
    for rank in range(WORLD):
        el = load(runs, "olmoe_pod", f"rank{rank}")["elastic"]
        assert el["step"] == 2 and el["same"], rank
        assert el["jax_step"] == 2 and el["jax_equal"], rank
        np.testing.assert_allclose(el["loss"], j["loss"], rtol=LOSS_RTOL)
    assert os.path.exists(os.path.join(runs, "port_ckpt", "step_2",
                                       "manifest.json"))
    assert not os.path.exists(os.path.join(runs, "port_ckpt", "step_2",
                                           "shard_1.npz"))


def test_init_on_mesh_draws_each_rank_its_shards(runs):
    """init_train_state(mesh=), which cuts each leaf as it is drawn, equals
    the one-process state's shards on every rank of every case."""
    for case in CASES:
        for rank in range(WORLD):
            assert load(runs, case["name"], f"rank{rank}")["init_sharded"], \
                (case["name"], rank)


def test_launch_train_runs_as_processes(tmp_path):
    """launch.train --model-parallel 2 as 4 ranks under torchrun (gloo):
    rank 0 prints the mesh and finite losses; the checkpoint is whole
    leaves written once."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("OMP_NUM_THREADS", None)        # torchrun sets 1 a rank
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--reduced", "--arch", "olmoe-1b-7b",
         "--model-parallel", "2", "--moe", "a2a", "--steps", "2",
         "--batch", "8", "--seq", "32", "--log-every", "1", "--ckpt-dir",
         ck, "--ckpt-every", "2"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "[mesh] (2, 2) ('data', 'model') over 4 ranks (gloo)" in out
    assert "moe_impl 'a2a'" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    with np.load(os.path.join(ck, "step_2", "shard_0.npz")) as z:
        assert z[".params/embed"].shape == (256, 64)
    assert sorted(os.listdir(os.path.join(ck, "step_2"))) == [
        "manifest.json", "shard_0.npz"]


def test_shape_only_trace_records_the_real_collectives(runs):
    """Reduced olmoe's train step at (2, 2): the (op, bytes, group size)
    records of each rank's real run equal those of the step traced on meta
    for that rank of ShapeMesh((2, 2)), in order."""
    for rank in range(WORLD):
        rec = load(runs, "olmoe_psum", f"rank{rank}")["records"]
        assert len(rec["real"]) > 0, rank
        assert {op for op, _, _ in rec["real"]} == {"all-reduce",
                                                    "all-gather"}, rank
        assert rec["real"] == rec["shape_only"], rank


def ulp_bf16(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def model_tol(ref, ulps=MODEL_ULPS) -> float:
    return ulps * ulp_bf16(max(float(np.abs(ref).max()), 1e-30))


def top2_margin(logits):
    part = np.sort(logits, axis=-1)
    return part[..., -1] - part[..., -2]


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_serving_matches_jax(runs, name):
    """Each rank's rows of the prefill and decode logits within MODEL_ULPS
    of JAX's largest magnitude (zamba2's and deepseek's decode:
    DRIFT_ULPS);
    its greedy tokens JAX's where JAX's top-2 margin is clear."""
    j = load(runs, name, "jax")
    case = SERVE_CASES[SERVE_NAMES.index(name)]
    for rank in range(WORLD):
        mine = load(runs, name, f"rank{rank}")
        rows = slice(*mine["rows"])
        for what, got, want, ulps in (
                ("prefill", mine["logits"], j["logits"], MODEL_ULPS),
                ("decode", mine["step_logits"], j["step_logits"],
                 case.get("decode_ulps", MODEL_ULPS))):
            tol = model_tol(want, ulps)
            np.testing.assert_allclose(got, want[rows], rtol=0, atol=tol,
                                       err_msg=f"{name} rank {rank} {what}")
            clear = top2_margin(want[rows]) > 2 * tol
            feed = j["feed"][rows]
            toks = feed[:, 0] if what == "prefill" else feed[:, 1:]
            assert (np.argmax(got, -1) == toks)[clear].all(), (rank, what)


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_serving_cache_shards_are_jax_slices(runs, name):
    """Each rank's decode cache shard is the slice of JAX's cache that
    JAX's NamedSharding of cache_specs gives its coordinate (within
    MODEL_ULPS; zamba2's and deepseek's DRIFT_ULPS)."""
    j = load(runs, name, "jax")
    case = SERVE_CASES[SERVE_NAMES.index(name)]
    for rank in range(WORLD):
        mine = load(runs, name, f"rank{rank}")
        coord = tuple(mine["coord"])
        assert len(mine["cache"]) == len(j["cache"])
        for k, (got, (leaf, layout)) in enumerate(zip(mine["cache"],
                                                      j["cache"])):
            want = leaf[tuple(slice(a, b) for a, b in layout[coord])]
            assert got.shape == want.shape, (name, rank, k)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=model_tol(leaf, case.get(
                                           "decode_ulps", MODEL_ULPS)),
                                       err_msg=f"{name} rank {rank} leaf {k}")


def test_serving_dense_matches_one_process(runs):
    """Reduced smollm served at (2, 2): each rank's prefill logits equal
    the port's one-process run's within MODEL_ULPS."""
    for rank in range(WORLD):
        mine = load(runs, "serve_smollm", f"rank{rank}")
        one = mine["one_process"]["logits"]
        np.testing.assert_allclose(mine["logits"], one, rtol=0,
                                   atol=model_tol(one))


@pytest.mark.parametrize("name", ONE_PROCESS_NAMES)
def test_serving_matches_one_process(runs, name):
    """Each rank's prefill and decode logits at (2, 2) are the port's
    one-process run's on its rows, and its cache shard that run's slice,
    within MODEL_ULPS: the mesh adds nothing to the port's numbers, so
    what DRIFT_ULPS allows against JAX is JAX's (2, 2) program's own
    drift."""
    j = load(runs, name, "jax")
    for rank in range(WORLD):
        mine = load(runs, name, f"rank{rank}")
        one = mine["one_process"]
        for what in ("logits", "step_logits"):
            np.testing.assert_allclose(
                mine[what], one[what], rtol=0, atol=model_tol(one[what]),
                err_msg=f"{name} rank {rank} {what}")
        coord, (r0, r1) = tuple(mine["coord"]), mine["rows"]
        assert len(mine["cache"]) == len(one["cache"])
        for k, (got, leaf, (_, layout)) in enumerate(zip(
                mine["cache"], one["cache"], j["cache"])):
            sl = [slice(a, b) for a, b in layout[coord]]
            assert (sl[1].start, sl[1].stop) == (r0, r1), (name, k)
            sl[1] = slice(None)          # the run holds only these rows
            want = leaf[tuple(sl)]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=model_tol(leaf),
                                       err_msg=f"{name} rank {rank} "
                                               f"leaf {k}")


def test_launch_serve_runs_as_processes():
    """launch.serve --model-parallel 2 as 4 ranks under torchrun (gloo):
    rank 0 prints the mesh and the generated tokens' line."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("OMP_NUM_THREADS", None)        # torchrun sets 1 a rank
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--reduced", "--arch", "olmoe-1b-7b",
         "--model-parallel", "2", "--batch", "4", "--prompt-len", "32",
         "--gen", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "[mesh] (2, 2) ('data', 'model') over 4 ranks (gloo)" in out
    assert "[serve] olmoe-reduced: batch=4 prompt=32 gen=4" in out
    assert out.count("[serve] device cpu x 4") == 1


def test_host_mesh_step_equals_one_card():
    """make_host_mesh(): a one-rank mesh on a one-process gloo group (an
    in-process store) with the production axis names; reduced olmoe's
    gradient on it equals the one-card step's bit for bit."""
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh("cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        cfg = get_reduced("olmoe_1b_7b")
        batch = to_device(SyntheticLM(DataConfig(
            seq_len=32, global_batch=2, vocab=cfg.vocab)).batch_at(0), "cpu")
        state = tstep.init_train_state(cfg, seed=0, device="cpu")
        one = tstep.make_grad_fn(cfg)(state.params, batch)
        on_mesh = tstep.make_grad_fn(cfg, mesh=mesh)(
            tstep.shard_train_state(state, cfg, mesh).params, batch)
        assert torch.equal(one[0], on_mesh[0])
        assert all(torch.equal(a, b) for a, b in zip(
            topt.tree_leaves(one[2]), topt.tree_leaves(on_mesh[2])))
        assert torch.allclose(on_mesh[3], topt.global_norm(one[2]),
                              rtol=1e-6)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
