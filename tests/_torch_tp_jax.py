"""The JAX side of the tensor-parallel and data-parallel MoE tests: a case's
weights and batch from seeds, JAX's single-device step on the global batch
(the oracle: JAX's own mesh paths fail on jax 0.9), its MoE layers' dropped
pairs, and the checks each case's ranks are held to."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jinit_opt_state
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch.configs import ARCHS
from repro_torch.models import params as PM

BATCH = (8, 32)
#: the encoder frames of an encoder-decoder's batch
FRAMES = 32
#: loss (absolute), gradients (of the leaf's largest entry), the update
#: (absolute), grad_norm (relative)
TOL = {"loss": 1e-5, "grad": 1e-4, "update": 1e-6, "grad_norm": 1e-5}


def configs(arch: str, **over) -> tuple:
    """(JAX config, port config): ``arch``'s smoke config with ``over`` set
    (MoE fields into the MoE block), the same on both sides."""
    out = []
    for registry in (JARCHS, ARCHS):
        cfg = registry[arch].smoke()
        moe = {k: over[k] for k in over if cfg.moe is not None and hasattr(cfg.moe, k)}
        rest = {k: v for k, v in over.items() if k not in moe}
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(dataclasses.replace(cfg, **rest))
    return tuple(out)


def case_inputs(jcfg, seed: int) -> tuple[dict, dict]:
    """(numpy JAX parameters of ``seed``, numpy global batch of ``seed``)."""
    jparams = JPM.materialize(jbuild_model(jcfg, mesh=None).layout(),
                              jax.random.PRNGKey(seed), jcfg.dtype)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab, BATCH).astype(np.int64),
             "labels": rng.integers(0, jcfg.vocab, BATCH).astype(np.int64)}
    if jcfg.vlm is not None:
        batch["img_emb"] = rng.normal(
            size=(BATCH[0], jcfg.vlm.n_image_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "encdec":
        batch["enc_emb"] = rng.normal(size=(BATCH[0], FRAMES, jcfg.d_model)).astype(np.float32)
    return jax.tree.map(np.asarray, jparams), batch


def jax_serve(jcfg, jparams: dict, inputs: dict, B: int) -> dict:
    """JAX's single-device prefill, teacher-forced decode steps from a zero
    cache (every step's logits, the cache at the end) and greedy engine on
    ``inputs`` (``tokens`` (B, L), ``prompt``, ``new``, ``cache_len``, and
    ``img_emb`` or ``enc_emb``, each None where the model takes none).  An
    encoder-decoder's decode cache holds the cross K and V of its encoder's
    output of ``enc_emb``, formed by its own ``_qkv``; its engine's cross
    cache of as many frames is zero."""
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServingEngine as JServingEngine

    model = jbuild_model(jcfg, mesh=None)
    params = jax.tree.map(jnp.asarray, jparams)
    tokens = inputs["tokens"]
    batch = {"tokens": jnp.asarray(tokens[:, :inputs["prompt"]], jnp.int32)}
    enc = inputs.get("enc_emb")
    for key in ("img_emb", "enc_emb"):
        if inputs.get(key) is not None:
            batch[key] = jnp.asarray(inputs[key])
    prefill = np.asarray(jax.jit(model.prefill)(params, batch))
    if enc is None:
        layout = model.cache_layout(B, inputs["cache_len"])
    else:
        layout = model.cache_layout(B, inputs["cache_len"], enc.shape[1])
    cache = JPM.materialize(layout, jax.random.PRNGKey(0), jcfg.dtype)
    if enc is not None:
        out = model.encode(params, jnp.asarray(enc))
        cp = params["dec_layers"]["cross_attn"]
        kv = [model._qkv(jax.tree.map(lambda t, i=i: t[i], cp), out, out)[1:]
              for i in range(jcfg.n_layers)]
        cache["layers"]["cross_k"] = jnp.stack([k for k, _ in kv])
        cache["layers"]["cross_v"] = jnp.stack([v for _, v in kv])
    decode = jax.jit(model.decode_step)
    steps = []
    for t in range(tokens.shape[1]):
        logits, cache = decode(params, {"tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                        "cache": cache, "index": jnp.asarray(t, jnp.int32)})
        steps.append(np.asarray(logits)[:, 0])
    engine = JServingEngine(model, params, cache_len=inputs["cache_len"], batch=B,
                            enc_len=0 if enc is None else enc.shape[1])
    generated = engine.generate(tokens[:, :inputs["prompt"]],
                                JServeConfig(max_new_tokens=inputs["new"]))
    return {"prefill": prefill, "steps": np.stack(steps), "generated": np.asarray(generated),
            "cache": jax.tree.map(np.asarray, cache)}


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def jax_step(jcfg, jparams: dict, batch: dict) -> dict:
    """JAX's single-device train step on the global batch, jitted: loss,
    metrics, gradients, grad_norm and the parameters after the AdamW update."""
    model = jbuild_model(jcfg, mesh=None)
    params = jax.tree.map(jnp.asarray, jparams)
    b = _jbatch(batch)
    opt_cfg = JAdamWConfig()

    @jax.jit
    def step(params, b):
        (loss, metrics), grads = jax.value_and_grad(lambda p: model.loss(p, b),
                                                    has_aux=True)(params)
        new, _, m = jadamw_update(grads, jinit_opt_state(params, opt_cfg), params, opt_cfg)
        return loss, metrics, grads, new, m

    loss, metrics, grads, new, m = step(params, b)
    return {"loss": float(loss), "nll": float(metrics["nll"]), "aux": float(metrics["aux"]),
            "grads": jax.tree.map(np.asarray, grads), "params": jax.tree.map(np.asarray, new),
            "grad_norm": float(m["grad_norm"])}


def jax_dropped(monkeypatch, jcfg, jparams: dict, batch: dict) -> list[int]:
    """The pairs each MoE layer of JAX's forward (jitted) drops on the global
    batch: ``repro.models.lm.moe_block`` wrapped (for this call only) to
    count, in JAX's arithmetic, the pairs past the capacity, reported through
    ``jax.debug.callback``."""
    import repro.models.lm as jlm

    seen, block = [], jlm.moe_block

    def counted(x, router_w, *args, top_k, capacity_factor=1.25, **kw):
        N, E = x.shape[0], router_w.shape[-1]
        C = max(1, int(math.ceil(N * top_k / E * capacity_factor)))
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), axis=-1)
        _, idx = lax.top_k(probs, top_k)
        flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(N * top_k, E)
        slot = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1)
        jax.debug.callback(lambda n: seen.append(int(n)), (slot >= C).sum())
        return block(x, router_w, *args, top_k=top_k, capacity_factor=capacity_factor, **kw)

    monkeypatch.setattr(jlm, "moe_block", counted)
    jax.jit(jbuild_model(jcfg, mesh=None).loss)(jax.tree.map(jnp.asarray, jparams),
                                                _jbatch(batch))
    jax.effects_barrier()
    monkeypatch.setattr(jlm, "moe_block", block)
    return seen


def jax_update(jparams: dict, grads: dict) -> tuple[dict, float]:
    """JAX's AdamW update of ``jparams`` from a fresh state by ``grads`` (numpy
    trees of JAX's structure): (the new parameters, grad_norm)."""
    params = jax.tree.map(jnp.asarray, jparams)
    g = jax.tree.map(jnp.asarray, jax.tree.unflatten(jax.tree.structure(params),
                                                     PM.tree_leaves(grads)))
    opt_cfg = JAdamWConfig()
    new, _, m = jax.jit(lambda g, p: jadamw_update(g, jinit_opt_state(p, opt_cfg), p,
                                                   opt_cfg))(g, params)
    return jax.tree.map(np.asarray, new), float(m["grad_norm"])


def check_against_jax(outs: list, want: dict, jparams: dict) -> None:
    """Every rank's case result against JAX's single-device step: loss, aux,
    the gathered gradient, grad_norm and the parameters after the step
    (within 1e-6); the parameters also against JAX's AdamW update by the
    same synced gradient (the optimizer alone, within 1e-6); and every
    replicated leaf (gradient and parameter) bit-equal across the ranks of
    each model group."""
    updated, norm = jax_update(jparams, outs[0]["grads"])
    assert abs(norm - outs[0]["grad_norm"]) <= TOL["grad_norm"] * norm
    for path, p, w, u in zip(PM._paths(outs[0]["params"]), PM.tree_leaves(outs[0]["params"]),
                             PM.tree_leaves(want["params"]), PM.tree_leaves(updated)):
        np.testing.assert_allclose(p, w, rtol=TOL["update"], atol=TOL["update"], err_msg=path)
        np.testing.assert_allclose(p, u, rtol=TOL["update"], atol=TOL["update"], err_msg=path)
    for out in outs:
        assert abs(out["loss"] - want["loss"]) <= TOL["loss"], (out["loss"], want["loss"])
        assert abs(out["aux"] - want["aux"]) <= TOL["loss"], (out["aux"], want["aux"])
        got, ref = PM.tree_leaves(out["grads"]), PM.tree_leaves(want["grads"])
        assert len(got) == len(ref)
        for path, g, w in zip(PM._paths(out["grads"]), got, ref):
            assert g.shape == w.shape, path
            assert np.abs(g - w).max() <= TOL["grad"] * np.abs(w).max(), path
        assert abs(out["grad_norm"] - want["grad_norm"]) <= TOL["grad_norm"] * want["grad_norm"]
        for path, p, q in zip(PM._paths(out["params"]), PM.tree_leaves(out["params"]),
                              PM.tree_leaves(outs[0]["params"])):
            np.testing.assert_array_equal(p, q, err_msg=path)
    for out in outs:
        group = [o for o in outs if o["coords"].get("data") == out["coords"].get("data")]
        for other in group:
            for key in ("grads_replicated", "params_replicated"):
                assert out[key].keys() == other[key].keys()
                for path in out[key]:
                    np.testing.assert_array_equal(out[key][path], other[key][path], err_msg=path)
