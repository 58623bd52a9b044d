"""Rank bodies of the port's multi-rank CPU tests.

Each runs in a process of a spawned ``gloo`` world (``mesh.run_ranks``), on
the CPU, and returns numpy arrays and numbers for the test to check.  This
module imports neither JAX nor the JAX package, so a spawned rank does not
load them.
"""

from __future__ import annotations

import os
import time
import zlib

import numpy as np
import torch

from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import NamedSharding
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.train import (AdamWConfig, CheckpointManager, DataParallelStep, adamw_update,
                               init_error_state, init_opt_state, two_level_grad_sync,
                               zero_shardings)

TIMEOUT = 60.0


def _np(tree):
    """numpy copies of a tree's tensors (never views: a step updates them in place)."""
    return PM.tree_map(lambda t: t.detach().cpu().numpy().copy() if torch.is_tensor(t) else t,
                       tree)


def _torch(tree):
    return PM.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def sync_grads(coords: dict, shapes: dict, seed: int) -> dict:
    """One rank's gradients: multiples of 2^-8 in [-2, 2], drawn from
    ``seed`` and the rank's (pod, data, model) coordinates, so that means
    over two ranks are exact in fp32."""
    rng = np.random.default_rng([seed, coords.get("pod", 0), coords["data"], coords["model"]])
    return {k: (rng.integers(-512, 513, size=s) / 256.0).astype(np.float32)
            for k, s in shapes.items()}


def die_apart(rank: int, world: int, init: str, delay: float) -> None:
    """Exit without a result: rank 0 at once, every other rank ``delay``
    seconds later."""
    if rank:
        time.sleep(delay)
    os._exit(3)


def sync_world(rank: int, world: int, init: str, shapes: dict) -> dict:
    """pod 2 x data 2 x model 2: the compressed sync twice (the second with
    the first's errors), the plain one, identical inputs, a bf16 leaf, and
    a mesh without ``pod`` over the same ranks."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(data=2, model=2, pods=2, backend="gloo", init_method=init, rank=rank,
                          timeout=TIMEOUT, device="cpu")
    grads = _torch(sync_grads(mesh.coords, shapes, 0))
    errors = init_error_state(grads)
    out = {"coords": mesh.coords}
    s1, e1 = two_level_grad_sync(grads, errors, mesh, compress=True)
    s2, e2 = two_level_grad_sync(grads, e1, mesh, compress=True)
    plain, same = two_level_grad_sync(grads, errors, mesh, compress=False)
    out.update(synced1=_np(s1), errors1=_np(e1), synced2=_np(s2), errors2=_np(e2),
               plain=_np(plain), plain_errors_same=same is errors,
               inputs_kept=all(torch.equal(a, b) for a, b in
                               zip(PM.tree_leaves(grads), PM.tree_leaves(_torch(
                                   sync_grads(mesh.coords, shapes, 0))))))
    # JAX's own check: replicated identical inputs
    rng = np.random.default_rng(1)
    same_in = {"w": torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))}
    synced, new_err = two_level_grad_sync(same_in, init_error_state(same_in), mesh)
    out["identical_rel_err"] = max(float((synced[k] - same_in[k]).abs().max()
                                         / same_in[k].abs().max()) for k in same_in)
    out["identical_residual"] = float(sum(v.abs().sum() for v in PM.tree_leaves(new_err)))
    # a bf16 leaf: the plain mean over (data, pod) summed in fp32, rounded once
    bf = {"g": grads["w"].to(torch.bfloat16) * 1.0078125}
    bf_synced, _ = two_level_grad_sync(bf, init_error_state(bf), mesh, compress=False)
    out["bf16_in"] = bf["g"].float().numpy()
    out["bf16_synced"] = bf_synced["g"].float().numpy()
    out["bf16_dtype"] = str(bf_synced["g"].dtype)
    # the same world viewed as data 4 x model 2: no pod axis
    flat = make_test_mesh(data=4, model=2, backend="gloo", timeout=TIMEOUT, device="cpu")
    flat_synced, flat_err = two_level_grad_sync(grads, e1, flat, compress=True)
    out.update(flat_coords=flat.coords, flat_synced=_np(flat_synced),
               flat_errors_same=flat_err is e1)
    return out


def flash_world(rank: int, world: int, init: str, inputs: dict, valids: tuple) -> dict:
    """data 2 x model 4: flash decoding of the whole cache, cut on its sequence
    over ``model``; the output at each valid length and this rank's shard."""
    from repro_torch.serve import make_flash_decode

    torch.set_num_threads(1)
    mesh = make_test_mesh(data=2, model=4, backend="gloo", init_method=init, rank=rank,
                          timeout=TIMEOUT, device="cpu")
    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    cut = NamedSharding(mesh, PM.P(None, None, "model", None))
    k_shard, v_shard = cut.shard(k), cut.shard(v)
    fn = make_flash_decode(mesh)
    outs = [fn(q, k_shard, v_shard, valid).numpy() for valid in valids]
    outs.append(fn(q, k_shard, v_shard, torch.tensor(valids[1])).numpy())
    return {"coords": mesh.coords, "outs": outs, "k_shard": k_shard.numpy(),
            "contiguous": k_shard.is_contiguous(),
            "gathered": bool(torch.equal(cut.gather(k_shard), k))}


def zero_world(rank: int, world: int, init: str, cfg, jparams: dict, batch: dict,
               ckpt_dir: str, moe_cfg) -> dict:
    """pod 2 x data 2 x model 1 on the qwen smoke config in fp32: the step in
    parts against ``adamw_update``, the step whole, a second step, a ZeRO
    checkpoint restored at data 4 on the same ranks."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(data=2, model=1, pods=2, backend="gloo", init_method=init,
                          rank=rank, timeout=TIMEOUT, device="cpu")
    model = build_model(cfg, model_axis=1, mesh=mesh, device="cpu")
    opt_cfg = AdamWConfig()
    params = PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = DataParallelStep(model, opt_cfg, mesh)
    out = {"coords": mesh.coords, "rows": step.rows(batch)["tokens"].numpy()}

    # step 1 in parts: the ZeRO-1 update against adamw_update on the same gradient
    loss, _, grads = step.grads(params, batch)
    synced = step.sync(grads)
    ref_params = PM.tree_map(lambda t: t.clone(), params)
    ref_params, ref_state, ref_m = adamw_update(synced, init_opt_state(ref_params, opt_cfg),
                                                ref_params, opt_cfg)
    zparams = PM.tree_map(lambda t: t.clone(), params)
    zstate = step.init_opt_state(zparams)
    zparams, zstate, zm = step.update(synced, zstate, zparams)
    sh = step.shardings
    out["update_equal"] = all(torch.equal(a, b) for a, b in
                              zip(PM.tree_leaves(zparams), PM.tree_leaves(ref_params)))
    out["state_equal"] = all(
        torch.equal(shard, s.shard(full)) for key in ("mu", "nu", "master")
        for shard, full, s in zip(PM.tree_leaves(zstate[key]), PM.tree_leaves(ref_state[key]),
                                  PM.tree_leaves(sh[key])))
    out["shards_contiguous"] = all(t.is_contiguous() for key in ("mu", "nu", "master")
                                   for t in PM.tree_leaves(zstate[key]))
    out["sharded_leaves"] = sum(t.shape != f.shape for t, f in
                                zip(PM.tree_leaves(zstate["mu"]), PM.tree_leaves(ref_state["mu"])))
    out["grad_norm_equal"] = bool(torch.equal(zm["grad_norm"], ref_m["grad_norm"]))
    out["local_loss"] = float(loss)
    out["synced"] = _np(synced)

    # the step whole, from the same start
    params, opt, m1 = step(params, step.init_opt_state(params), batch)
    out["loss"] = float(m1["loss"])
    out["call_equal"] = all(torch.equal(a, b) for a, b in
                            zip(PM.tree_leaves(params), PM.tree_leaves(zparams)))
    params, opt, m2 = step(params, opt, batch)
    out["loss2"] = float(m2["loss"])
    out["params"] = _np(params)
    out["times"] = dict(step.times)
    # a whole step with the compressed sync, on copies
    step_c = DataParallelStep(model, opt_cfg, mesh, compress=True)
    copies = PM.tree_map(lambda t: t.clone(), {"params": params, "opt": opt})
    p_c, _, m_c = step_c(copies["params"], copies["opt"], batch)
    out["compressed"] = {"loss": float(m_c["loss"]), "params": _np(p_c),
                         "residual": float(sum(e.abs().sum()
                                               for e in PM.tree_leaves(step_c.errors)))}

    # elastic restore: save the ZeRO state, restore it at data 4 over the same ranks
    ckpt = CheckpointManager(ckpt_dir, keep=1)
    shardings = {"params": PM.tree_map(lambda _: None, params), "opt": sh}
    ckpt.save(2, params, opt, shardings=shardings, mesh_shape=dict(mesh.shape))
    wide = make_test_mesh(data=4, model=1, pods=1, backend="gloo", timeout=TIMEOUT,
                          device="cpu")
    wide_sh = zero_shardings(model.layout(), wide, opt_cfg)
    _, p_b, o_b, _ = ckpt.restore(template={"params": params, "opt": opt},
                                  shardings={"params": shardings["params"], "opt": wide_sh})
    _, p_full, o_full, _ = ckpt.restore(template={"params": params, "opt": opt})
    out["restored_params_equal"] = all(torch.equal(a, b) for a, b in
                                       zip(PM.tree_leaves(p_b), PM.tree_leaves(params)))
    out["restored_shards_equal"] = all(
        torch.equal(got, s.shard(full)) for key in ("mu", "nu", "master")
        for got, full, s in zip(PM.tree_leaves(o_b[key]), PM.tree_leaves(o_full[key]),
                                PM.tree_leaves(wide_sh[key])))
    out["restored_own_shards_equal"] = all(
        torch.equal(mine, s.shard(full)) for key in ("mu", "nu", "master")
        for mine, full, s in zip(PM.tree_leaves(opt[key]), PM.tree_leaves(o_full[key]),
                                 PM.tree_leaves(sh[key])))
    out["restored_count"] = int(o_b["count"])
    out["wide_coords"] = wide.coords

    # refusals: a model axis the model was not built over, MoE over data
    # ranks without the mesh (its routing is the global batch's)
    tp = make_test_mesh(data=2, model=2, backend="gloo", timeout=TIMEOUT, device="cpu")
    refused = []
    for m, mdl in ((tp, model), (mesh, build_model(moe_cfg, model_axis=1, device="cpu"))):
        try:
            DataParallelStep(mdl, opt_cfg, m)
        except ValueError as err:
            refused.append(str(err))
    out["refused"] = refused
    return out


# ------------------------------------------------------- tensor parallelism
def _gathered(tree, step) -> dict:
    """Every leaf of a rank's tree (its ``model`` shards) gathered whole: the
    cut leaves side by side in one all-gather over the axis."""
    mesh, shs, leaves = step.mesh, PM.tree_leaves(step.param_shardings()), PM.tree_leaves(tree)
    cut = [i for i, sh in enumerate(shs) if sh.axes()]
    out = list(leaves)
    if cut:
        parts = mesh.all_gather(torch.cat([leaves[i].reshape(-1) for i in cut]), "model")
        start = 0
        for i in cut:
            n, shape = leaves[i].numel(), leaves[i].shape
            out[i] = leaves[i].new_empty(shs[i].full_shape(shape))
            for rank, part in zip(mesh.group_ranks("model"), parts):
                out[i][shs[i].index_of(mesh.coords_of(rank), out[i].shape)] = \
                    part[start:start + n].view(shape)
            start += n
    it = iter(out)
    return PM.tree_map(lambda _: next(it), tree)


def _replicated(tree, step) -> dict:
    """``{path: numpy}`` of the leaves the layout does not cut on ``model``."""
    out = {}
    for path, t, sh in zip(PM._paths(tree), PM.tree_leaves(tree),
                           PM.tree_leaves(step.param_shardings())):
        if "model" not in sh.axes():
            out[path] = t.detach().cpu().numpy().copy()
    return out


def _moe_layers(cfg) -> int:
    if cfg.moe is None:
        return 0
    return cfg.n_layers - (1 if cfg.moe.first_dense else 0)


def _local_capacity_keep(route, top_k: int, capacity_factor: float):
    """The keep mask of ``route``'s experts with the capacity and queue of
    this rank's rows alone (what a rank-local routing would give)."""
    import math

    N, E = route.probs.shape
    flat = torch.zeros((N * top_k, E), dtype=torch.int64)
    flat.scatter_(1, route.idx.reshape(-1, 1), 1)
    slot = ((flat.cumsum(0) - flat) * flat).sum(-1).view(N, top_k)
    return slot < max(1, int(math.ceil(N * top_k / E * capacity_factor)))


def tp_case(mesh, cfg, jparams: dict, batch: dict, *, steps: int = 1) -> dict:
    """One case on ``mesh``: the model built over it, the JAX tree cut into
    this rank's shards, ``steps`` steps of ``make_train_step(model, opt, mesh)``,
    the first in its parts.  Returns the first step's loss, metrics, the
    synced gradient gathered whole, the parameters after it gathered whole,
    the replicated leaves as this rank holds them (gradient and parameters,
    and the parameters after the last step), and for an MoE model each
    layer's routing of the forward."""
    from repro_torch.models import layers
    from repro_torch.train import make_train_step

    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cpu")
    full = PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype)
    params = PM.shard_params(full, model.layout(), mesh)
    rows = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = make_train_step(model, AdamWConfig(), mesh)
    opt = step.init_opt_state(params)
    seen, route = [], layers.moe_route

    def record(*args, **kwargs):
        seen.append(route(*args, **kwargs))
        return seen[-1]

    layers.moe_route = record
    try:
        loss, metrics, grads = step.grads(params, rows)
    finally:
        layers.moe_route = route
    synced = step.sync(grads)
    params, opt, m = step.update(synced, opt, params)
    out = {"coords": dict(mesh.coords), "loss": float(step.mean_over_ranks(loss)),
           **{k: float(step.mean_over_ranks(v)) for k, v in metrics.items()},
           "grad_norm": float(m["grad_norm"]),
           "grads": _np(_gathered(synced, step)), "grads_replicated": _replicated(synced, step),
           "shapes": {p: tuple(t.shape) for p, t in zip(PM._paths(params),
                                                         PM.tree_leaves(params))}}
    out["params"] = _np(_gathered(params, step))
    out["params_replicated"] = _replicated(params, step)
    for _ in range(steps - 1):
        params, opt, m = step(params, opt, rows)
        out.setdefault("later_losses", []).append(float(m["loss"]))
        out["later_replicated"] = _replicated(params, step)
    L = _moe_layers(cfg)
    if L:
        fwd = seen[:L]
        moe = cfg.moe
        out["dropped"] = [int((~r.keep).sum()) for r in fwd]
        out["capacity"] = [r.capacity for r in fwd]
        out["local_routing_differs"] = [
            bool((_local_capacity_keep(r, moe.top_k, moe.capacity_factor) != r.keep).any())
            for r in fwd]
    out["_state"] = (model, step, params, opt)
    return out


#: the counts a real rank's step and the dry-run's meta count of it must share
COUNT_KEYS = ("flops", "traffic_bytes", "matmul_flops", "aten_bytes", "kernels", "collectives",
              "collective_bytes", "start_bytes")


def train_count(mesh, cfg, jparams: dict, batch: dict) -> dict:
    """One rank's step of ``make_train_step(model, opt, mesh)`` on the global
    ``batch`` counted, and the same step on meta under an ``AbstractMesh`` as
    the dry-run counts it (``train.step.tp_step_costs``)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline import count as C
    from repro_torch.train import make_train_step
    from repro_torch.train.step import tp_step_costs

    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cpu")
    fresh = PM.shard_params(PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype),
                            model.layout(), mesh)
    rows = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = make_train_step(model, AdamWConfig(), mesh)
    real = C.count(step, fresh, step.init_opt_state(fresh), rows)[1]
    abstract = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names, rank=mesh.rank)
    meta_model = build_model(cfg, model_axis=mesh.shape["model"], mesh=abstract, device="meta")
    meta_rows = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in rows.items()}
    meta = tp_step_costs(meta_model, meta_rows, abstract)
    return {"real": {k: real[k] for k in COUNT_KEYS}, "meta": {k: meta[k] for k in COUNT_KEYS}}


def tp_world(rank: int, world: int, init: str, cases: list, ckpt_dir: str) -> dict:
    """Each case ``(name, (data, model), cfg, jparams, batch, steps)`` on a
    mesh of that shape over the same 4 ranks (``tp_case``); the ZeRO + TP
    state of the first case saved and restored at data 1 x model 4; one
    rank's step counted against the meta count the dry-run makes."""
    from repro_torch.train import make_train_step

    torch.set_num_threads(1)
    meshes, out = {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_test_mesh(data=shape[0], model=shape[1], backend="gloo",
                                           init_method=init, rank=rank, timeout=TIMEOUT,
                                           device="cpu")
        return meshes[shape]

    first = None
    for name, shape, cfg, jparams, batch, steps in cases:
        res = tp_case(mesh_of(shape), cfg, jparams, batch, steps=steps)
        state = res.pop("_state")
        first = first or (shape, cfg, state)
        out[name] = res

    if ckpt_dir:
        shape, cfg, (model, step, params, opt) = first
        sh = {"params": step.param_shardings(), "opt": step.shardings}
        ckpt = CheckpointManager(ckpt_dir, keep=1)
        ckpt.save(int(opt["count"]), params, opt, shardings=sh,
                  mesh_shape=dict(step.mesh.shape))
        tall = mesh_of((1, 4))
        tall_model = build_model(cfg, model_axis=4, mesh=tall, device="cpu")
        tall_step = make_train_step(tall_model, AdamWConfig(), tall)
        tall_sh = {"params": tall_step.param_shardings(), "opt": tall_step.shardings}
        _, p_b, o_b, _ = ckpt.restore(template={"params": params, "opt": opt}, shardings=tall_sh)
        equal, crcs = True, []
        for mine, s, got, ts in zip(PM.tree_leaves({"params": params, "opt": opt}),
                                    PM.tree_leaves(sh), PM.tree_leaves({"params": p_b,
                                                                        "opt": o_b}),
                                    PM.tree_leaves(tall_sh)):
            whole = mine if s is None else s.gather(mine)
            equal &= bool(torch.equal(got, whole if ts is None else ts.shard(whole)))
            crcs.append(zlib.crc32(whole.contiguous().numpy().tobytes()))
        out["checkpoint"] = {"shards_equal": equal, "crcs": crcs,
                             "tall_coords": dict(tall.coords),
                             "sharded_opt_leaves": sum(
                                 "model" in s.axes() and "data" in s.axes()
                                 for s in PM.tree_leaves(sh["opt"]["mu"]))}

        # one rank's step counted, and the same step on meta under an AbstractMesh
        out["count"] = train_count(step.mesh, cfg, cases[0][3], cases[0][4])
    return out


# ------------------------------------------------ serving over the model axis
def tp_serve_case(mesh, cfg, jparams: dict, case: dict) -> dict:
    """One serving case on ``mesh``: the JAX tree cut into this rank's shards,
    ``prefill`` of the first ``prompt`` tokens of this rank's rows, every
    token of ``tokens`` decoded teacher-forced through ``decode_step`` from
    an empty cache of ``cache_len`` slots (the logits of each step and this
    rank's cache shard at the end), and ``ServingEngine.generate`` (greedy)
    on the global prompts.  An encoder-decoder's case holds ``enc_emb``: the
    prefill reads its rows, the decode's cross cache is filled from
    ``encode`` of them (``fill_cross``), the engine's cross cache of as many
    frames stays zero, as JAX's does."""
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import data_rows

    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cpu")
    params = PM.shard_params(PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype),
                             model.layout(), mesh)
    tokens = torch.from_numpy(case["tokens"])
    B, L = tokens.shape
    axes, rows = data_rows(mesh, B)
    split = model.rows_split(axes)
    batch = {"tokens": tokens[rows, :case["prompt"]]}
    if case.get("img_emb") is not None:
        batch["img_emb"] = torch.from_numpy(case["img_emb"])[rows]
    enc_len = 0
    if case.get("enc_emb") is not None:
        batch["enc_emb"] = torch.from_numpy(case["enc_emb"])[rows]
        enc_len = batch["enc_emb"].shape[1]
    with split:
        prefill = model.prefill(params, batch)
        if enc_len:
            cache = model.init_cache(B, case["cache_len"], enc_len)
            with torch.no_grad():
                model.fill_cross(params, cache, model.encode(params, batch["enc_emb"]))
        else:
            cache = model.init_cache(B, case["cache_len"])
        steps = []
        for t in range(L):
            logits, cache = model.decode_step(params, {"tokens": tokens[rows, t:t + 1],
                                                       "cache": cache, "index": t})
            steps.append(logits[:, 0].numpy().copy())
    engine = ServingEngine(model, params, cache_len=case["cache_len"], batch=B, enc_len=enc_len)
    generated = engine.generate(case["tokens"][:, :case["prompt"]],
                                ServeConfig(max_new_tokens=case["new"]))
    return {"coords": dict(mesh.coords), "rows": (rows.start, rows.stop),
            "prefill": prefill.numpy(), "steps": np.stack(steps), "cache": _np(cache),
            "cache_dtype": str(PM.tree_leaves(cache)[0].dtype), "generated": generated}


def tp_serve_world(rank: int, world: int, init: str, cases: list, count_case: tuple) -> dict:
    """Each case ``(name, (data, model), cfg, jparams, case)`` on a mesh of that
    shape over the same 4 ranks (``tp_serve_case``); then the decode step and
    the prefill of ``count_case`` ``(name, (data, model), cfg, jparams, B, S)``
    counted on this rank and on meta under an ``AbstractMesh`` as the dry-run
    counts them (``train.step.tp_serve_costs``)."""
    torch.set_num_threads(1)
    meshes, out = {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_test_mesh(data=shape[0], model=shape[1], backend="gloo",
                                           init_method=init, rank=rank, timeout=TIMEOUT,
                                           device="cpu")
        return meshes[shape]

    for name, shape, cfg, jparams, case in cases:
        out[name] = tp_serve_case(mesh_of(shape), cfg, jparams, case)

    name, shape, cfg, jparams, B, S = count_case
    out["count"] = serve_count(mesh_of(shape), cfg, jparams, B, S)
    return out


def serve_count(mesh, cfg, jparams: dict, B: int, S: int) -> dict:
    """One rank's decode step (the last slot of a cache of ``S``) and prefill
    (``S`` positions) for ``B`` requests counted, and each on meta under an
    ``AbstractMesh`` as the dry-run counts them (``train.step.tp_serve_costs``;
    an encoder-decoder's cross cache of ``registry.WHISPER_DECODE_ENC_LEN``
    frames, its prefill over ``S`` frames)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import WHISPER_DECODE_ENC_LEN
    from repro_torch.roofline import count as C
    from repro_torch.serve.engine import data_rows
    from repro_torch.train.step import tp_serve_costs

    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cpu")
    params = PM.shard_params(PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype),
                             model.layout(), mesh)
    axes, rows = data_rows(mesh, B)
    n = rows.stop - rows.start
    abstract = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names, rank=mesh.rank)
    meta_model = build_model(cfg, model_axis=mesh.shape["model"], mesh=abstract, device="meta")
    encdec = cfg.family == "encdec"
    cache = (model.init_cache(B, S, WHISPER_DECODE_ENC_LEN) if encdec
             else model.init_cache(B, S))
    prefill = {"tokens": torch.zeros((n, S), dtype=torch.int32)}
    if encdec:
        prefill["enc_emb"] = torch.zeros((n, S, cfg.d_model))
    out = {}
    with model.rows_split(axes):
        for kind, step, inputs in (
                ("decode", model.decode_step, {"tokens": torch.zeros((n, 1), dtype=torch.int32),
                                               "cache": cache, "index": S - 1}),
                ("prefill", model.prefill, prefill)):
            real = C.count(step, params, inputs)[1]
            meta = tp_serve_costs(meta_model, abstract, kind, B, S)
            out[kind] = {"real": {k: real[k] for k in COUNT_KEYS},
                         "meta": {k: meta[k] for k in COUNT_KEYS}}
    return out


def hymba_ssm_in(model, jparams: dict) -> dict:
    """A Hymba rank's in-projection of a seeded input through its shard of the
    first block's ``w_in`` (``Hymba._ssm_in``), beside the channels of x and
    z it should hold: its contiguous ``ed/tp`` of each, sliced from every
    rank's product with its own shard (the values the exchange moves)."""
    from repro_torch.parallel import NamedSharding

    w = torch.from_numpy(np.asarray(jparams["global_0"]["w_in"], np.float32))
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, w.shape[0])).astype(
        np.float32))
    shard = NamedSharding(model.mesh, (None, "model")).shard(w)
    with torch.no_grad():
        x, z = model._ssm_in({"w_in": shard}, h)
    c, ed = model.ed // model.tp, model.ed
    whole = torch.cat([h @ part.contiguous() for part in w.chunk(model.tp, -1)], -1)
    r = model.tp_rank
    return {"x": x.numpy(), "z": z.numpy(), "want_x": whole[..., r * c:(r + 1) * c].numpy(),
            "want_z": whole[..., ed + r * c:ed + (r + 1) * c].numpy()}


def tp_family_world(rank: int, world: int, init: str, train_cases: list, serve_cases: list,
                    count_case: tuple) -> dict:
    """One family's cases over the same 4 ranks: each train case ``(name,
    (data, model), cfg, jparams, batch)`` (``tp_case``), each serving case
    ``(name, (data, model), cfg, jparams, case)`` (``tp_serve_case``), then
    ``count_case`` ``((data, model), cfg, jparams, batch, B, S)``: a rank's
    train step, decode step and prefill counted real and on meta
    (``train_count``, ``serve_count``)."""
    torch.set_num_threads(1)
    meshes, out = {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_test_mesh(data=shape[0], model=shape[1], backend="gloo",
                                           init_method=init, rank=rank, timeout=TIMEOUT,
                                           device="cpu")
        return meshes[shape]

    for name, shape, cfg, jparams, batch in train_cases:
        res = tp_case(mesh_of(shape), cfg, jparams, batch)
        model = res.pop("_state")[0]
        if cfg.family == "hybrid":
            res["ssm_in"] = hymba_ssm_in(model, jparams)
        out[name] = res
    for name, shape, cfg, jparams, case in serve_cases:
        out[f"serve_{name}"] = tp_serve_case(mesh_of(shape), cfg, jparams, case)
    shape, cfg, jparams, batch, B, S = count_case
    out["count"] = {"train": train_count(mesh_of(shape), cfg, jparams, batch),
                    **serve_count(mesh_of(shape), cfg, jparams, B, S)}
    return out
