"""The port's MoE and MLA decoder on the CPU, held against the JAX package.

``moe_block`` and its routing are compared with JAX's ``layers.moe_block`` on
numpy-seeded inputs across token counts, expert counts, top-k and capacity
factors (drops included), with shared experts and a forced tie.  The two MoE
configs, mixtral-8x7b (top-2 of 8 experts, sliding window) and
deepseek-v2-lite-16b (MLA attention, 2 shared experts, a dense ``layer0``),
run at their smoke sizes in fp32 with the JAX model's parameters carried over
by ``params_from_jax``: decode logits and caches within 1e-4, greedy tokens
exactly, the loss within 1e-5 and every gradient leaf within 1e-4 of its
largest entry, and three AdamW train steps within 1e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import params as JPM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenDatasetSpec, read_items
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import build_model, layers
from repro_torch.models import params as PM
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train import AdamWConfig, config_digest, make_train_step

MOE_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, *, window=None):
    """(jax model, jax params, port model, port params) of ``arch``'s smoke config,
    with its sliding window set to ``window`` where given."""
    jcfg, cfg = JARCHS[arch].smoke(), ARCHS[arch].smoke()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(cfg, device="cpu")
    return jmodel, jparams, model, PM.params_from_jax(_np(jparams), device="cpu", dtype=None)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return _pair(request.param)


def _jax_route(x, router_w, top_k, capacity_factor):
    """The routing lines of JAX's ``layers.moe_block``: (gates, idx, slot, keep)."""
    N = x.shape[0]
    E = router_w.shape[1]
    C = max(1, int(math.ceil(N * top_k / E * capacity_factor)))
    logits = x.astype(jnp.float32) @ router_w.astype(jnp.float32)
    gates, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    gates = gates / jnp.clip(gates.sum(-1, keepdims=True), 1e-9)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(N * top_k, E)
    slot = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(N, top_k)
    keep = slot < C
    return gates, idx, jnp.where(keep, slot, C - 1), keep


def _moe_inputs(rng, N, E, D, F, shared: bool):
    def draw(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    args = [draw(N, D), draw(D, E, scale=0.3), draw(E, D, F, scale=D ** -0.5),
            draw(E, D, F, scale=D ** -0.5), draw(E, F, D, scale=F ** -0.5)]
    extra = [draw(D, 2 * F, scale=D ** -0.5), draw(D, 2 * F, scale=D ** -0.5),
             draw(2 * F, D, scale=(2 * F) ** -0.5)] if shared else None
    return args, extra


def _run_both(args, extra, top_k, cf):
    jy, jaux = jlayers.moe_block(*map(jnp.asarray, args), top_k=top_k, capacity_factor=cf,
                                 shared=None if extra is None else tuple(map(jnp.asarray, extra)))
    t = [torch.from_numpy(a) for a in args]
    y, aux = layers.moe_block(*t, top_k=top_k, capacity_factor=cf,
                              shared=None if extra is None else
                              tuple(torch.from_numpy(a) for a in extra))
    return (np.asarray(jy), float(jaux)), (y, aux)


#: (N tokens, E experts, top k, capacity factor, shared experts): deepseek's
#: decode routing at 8 requests (C 1: most pairs dropped), mixtral's (C 3),
#: heavy drops at a capacity factor of 0.5, none at 4.0, one token
MOE_CASES = ((8, 64, 6, 1.25, True), (8, 8, 2, 1.25, False), (24, 4, 2, 0.5, True),
             (16, 4, 2, 4.0, False), (1, 4, 1, 1.25, False), (40, 16, 3, 1.25, True))


@pytest.mark.parametrize("N,E,k,cf,shared", MOE_CASES)
def test_moe_block_matches_jax(N, E, k, cf, shared):
    """Routing exactly JAX's (experts, slots, drops), gates within 1e-6, y within
    1e-5 and the aux loss within 1e-6."""
    rng = np.random.default_rng(N * 100 + E)
    args, extra = _moe_inputs(rng, N, E, 32, 16, shared)
    jg, jidx, jslot, jkeep = _jax_route(jnp.asarray(args[0]), jnp.asarray(args[1]), k, cf)
    r = layers.moe_route(torch.from_numpy(args[0]), torch.from_numpy(args[1]), top_k=k,
                         capacity_factor=cf)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(r.slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(r.gates.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert r.capacity == max(1, math.ceil(N * k / E * cf))
    if cf < 1.25:
        assert not r.keep.all()
    (jy, jaux), (y, aux) = _run_both(args, extra, k, cf)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - jaux) <= 1e-6


def test_moe_route_breaks_ties_as_lax_top_k():
    """Equal probabilities take the lower expert first, as ``lax.top_k`` does:
    two equal router columns, and an all-zero router (every expert equal)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 32)).astype(np.float32)
    router = rng.normal(size=(32, 6)).astype(np.float32)
    router[:, 4] = router[:, 1]
    for w in (router, np.zeros_like(router)):
        _, jidx, jslot, _ = _jax_route(jnp.asarray(x), jnp.asarray(w), 3, 1.25)
        r = layers.moe_route(torch.from_numpy(x), torch.from_numpy(w), top_k=3,
                             capacity_factor=1.25)
        np.testing.assert_array_equal(r.idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(r.slot.numpy(), np.asarray(jslot))
    assert (r.idx.numpy() == [0, 1, 2]).all()                  # the all-zero router
    r = layers.moe_route(torch.from_numpy(x), torch.from_numpy(router), top_k=3,
                         capacity_factor=1.25)
    one, four = (r.idx.numpy() == 1).any(1), (r.idx.numpy() == 4).any(1)
    assert (one & ~four).any() and not (four & ~one).any()     # a tie at the k-th gate


def test_moe_route_replays_a_choice():
    """``choice`` replays experts chosen elsewhere: its own choice gives the
    same route bit for bit; another gives that choice's probabilities,
    renormalised, and the slots and drops that follow from it."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(12, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    own = layers.moe_route(x, w, top_k=2, capacity_factor=1.0)
    again = layers.moe_route(x, w, top_k=2, capacity_factor=1.0, choice=own.idx)
    for a, b in zip(own[:5], again[:5]):
        assert torch.equal(a, b)
    other = own.idx.flip(-1).clone()
    other[0] = torch.tensor([3, 1]) if set(own.idx[0].tolist()) != {3, 1} else torch.tensor([0, 2])
    r = layers.moe_route(x, w, top_k=2, capacity_factor=1.0, choice=other)
    assert torch.equal(r.idx, other)
    want = own.probs.gather(1, other)
    torch.testing.assert_close(r.gates, want / want.sum(-1, keepdim=True), rtol=0, atol=0)
    flat = torch.nn.functional.one_hot(other.reshape(-1), 4)
    slot = ((flat.cumsum(0) - flat) * flat).sum(-1).view(12, 2)
    assert torch.equal(r.keep, slot < r.capacity)
    assert torch.equal(r.slot, torch.where(slot < r.capacity, slot, r.capacity - 1))


def test_moe_block_is_deterministic():
    """Two calls give the same bits: every kept slot gets one nonzero source."""
    rng = np.random.default_rng(9)
    args, extra = _moe_inputs(rng, 24, 4, 32, 16, True)
    t = [torch.from_numpy(a) for a in args]
    sh = tuple(torch.from_numpy(a) for a in extra)
    y1, a1 = layers.moe_block(*t, top_k=2, capacity_factor=0.5, shared=sh)
    y2, a2 = layers.moe_block(*t, top_k=2, capacity_factor=0.5, shared=sh)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_fields_match_jax(arch, full):
    """Every field, the nested MoE and MLA blocks and the layout's shapes are
    JAX's, so ``config_digest`` (a hash of the repr) is JAX's too."""
    cfg = ARCHS[arch] if full else ARCHS[arch].smoke()
    jcfg = JARCHS[arch] if full else JARCHS[arch].smoke()
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(type(jcfg))]
    assert repr(cfg) == repr(jcfg)
    assert config_digest(cfg) == jconfig_digest(jcfg)
    shapes = [i.shape for i in PM.tree_leaves(build_model(cfg, device="cpu").layout())]
    jlayout = jbuild_model(jcfg, mesh=None).layout()
    assert shapes == [i.shape for i in jax.tree.leaves(
        jlayout, is_leaf=lambda x: isinstance(x, JPM.ParamInfo))]


def test_mla_cache_is_latent_sized():
    """DeepSeek's decode cache holds the latent and the RoPE key, over every
    position (no ring), with ``layer0`` beside the stack."""
    cfg = ARCHS["deepseek-v2-lite-16b"].smoke()
    lay = build_model(cfg, device="cpu").cache_layout(2, 64)
    assert sorted(lay) == ["layer0", "layers"]
    assert {i.shape[-1] for i in PM.tree_leaves(lay)} == {cfg.mla.kv_lora_rank,
                                                          cfg.mla.qk_rope_dim}
    assert lay["layer0"]["c_kv"].shape == (2, 64, cfg.mla.kv_lora_rank)
    assert lay["layers"]["k_rope"].shape == (cfg.n_layers - 1, 2, 64, cfg.mla.qk_rope_dim)


def test_sliding_window_cache_is_window_sized():
    cfg = ARCHS["mixtral-8x7b"].smoke()           # window 64 in smoke
    lay = build_model(cfg, device="cpu").cache_layout(2, 4096)
    assert all(i.shape[-2] == cfg.sliding_window for i in PM.tree_leaves(lay))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_and_cache_from_jax_keep_layout(arch):
    """``params_from_jax`` and ``cache_from_jax`` carry ``layer0`` and the
    stacked experts leaf for leaf: the JAX tree's names, shapes and values."""
    jmodel, jparams, model, params = _pair(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [tuple(t.shape) for t in PM.tree_leaves(params)] == [
        i.shape for i in PM.tree_leaves(model.layout())]
    for (_, leaf), t in zip(jflat, PM.tree_leaves(params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert ("layer0" in params) == (arch == "deepseek-v2-lite-16b")
    jcache = JPM.materialize(jmodel.cache_layout(2, 12), jax.random.PRNGKey(2), "float32")
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(2, 12), device="cpu",
                              dtype="float32")
    for a, b in zip(PM.tree_leaves(cache), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        PM.cache_from_jax(_np(jcache), model.cache_layout(2, 13), device="cpu", dtype="float32")


def test_mla_decode_attn_matches_jax():
    """One MLA ``_decode_attn`` of ``layer0`` and of a stacked layer at several
    indices of a random latent cache: output and both cache leaves within 1e-4."""
    jmodel, jparams, model, params = _pair("deepseek-v2-lite-16b")
    B, S = 3, 16
    rng = np.random.default_rng(6)
    for name, jp, p in (("layer0", jparams["layer0"]["attn"], params["layer0"]["attn"]),
                        ("layers", jax.tree.map(lambda t: t[0], jparams["layers"]["attn"]),
                         {k: t[0] for k, t in params["layers"]["attn"].items()})):
        for index in (0, 7, S - 1):
            x = rng.normal(size=(B, 1, model.cfg.d_model)).astype(np.float32)
            cache = {"c_kv": rng.normal(size=(B, S, model.cfg.mla.kv_lora_rank)),
                     "k_rope": rng.normal(size=(B, S, model.cfg.mla.qk_rope_dim))}
            cache = {k: v.astype(np.float32) for k, v in cache.items()}
            jout, jc = jmodel._decode_attn(jp, jnp.asarray(x),
                                           {k: jnp.asarray(v) for k, v in cache.items()}, index)
            tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
            out = model._decode_attn(p, torch.from_numpy(x), tc, index,
                                     torch.tensor([index]), torch.arange(S) <= index)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL, err_msg=name)
            for k in cache:
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("arch,window,start,steps", [
    ("deepseek-v2-lite-16b", None, 3, 16),
    ("mixtral-8x7b", None, 3, 16),
    ("mixtral-8x7b", 8, 2, 20),                   # through the ring of 8 slots
])
def test_moe_decode_steps_match_jax(arch, window, start, steps):
    """Decode steps from a random cache: logits at every step and every cache
    leaf at the end within 1e-4."""
    jmodel, jparams, model, params = _pair(arch, window=window)
    B, S = 3, start + steps + 4
    jcache = JPM.materialize(jmodel.cache_layout(B, S), jax.random.PRNGKey(1), "float32")
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(B, S), device="cpu",
                              dtype="float32")
    if window:
        assert cache["layers"]["k"].shape[3] == window
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, steps), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache,
                                            "index": jnp.asarray(start + t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": start + t})
        assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for a, b in zip(PM.tree_leaves(cache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mla_decode_past_cache_end_raises():
    """MLA's latent cache has no ring: where JAX clamps the index, the port raises."""
    _, _, model, params = _pair("deepseek-v2-lite-16b")
    cache = model.init_cache(1, 4)
    with pytest.raises(IndexError):
        model.decode_step(params, {"tokens": torch.zeros(1, 1, dtype=torch.int64),
                                   "cache": cache, "index": 4})


def test_moe_greedy_generate_matches_jax(pair):
    """The JAX launcher's defaults: 4 requests, prompt 16, 8 new tokens."""
    jmodel, jparams, model, params = pair
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(4), items_per_chunk=8)
    jout = JServingEngine(jmodel, jparams, cache_len=32, batch=4).generate(
        prompts, JServeConfig(max_new_tokens=8))
    out = ServingEngine(model, params, cache_len=32, batch=4).generate(
        prompts, ServeConfig(max_new_tokens=8))
    assert out.dtype == np.int32 and out.shape == (4, 8)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_moe_loss_and_grads_match_jax(pair):
    """Loss within 1e-5, aux within 1e-6 and every gradient leaf (the router's
    and the experts' among them) within 1e-4 of its largest entry."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(3)
    toks, labels = (rng.integers(0, model.cfg.vocab, (2, 40)).astype(np.int32) for _ in "tl")
    (jloss, jmetrics), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, {"tokens": torch.from_numpy(toks).long(),
                                        "labels": torch.from_numpy(labels).long()})
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert float(metrics["aux"].detach()) > 0
    assert abs(float(metrics["aux"].detach()) - float(jmetrics["aux"])) < 1e-6
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_moe_three_train_steps_match_jax(pair):
    """Three AdamW steps (the router, the experts, the aux loss and, for
    deepseek, MLA and layer0 through the backward) from JAX's parameters and
    optimizer state: loss, grad norm and learning rate each step within 1e-4,
    then every parameter."""
    jmodel, jparams, model, _ = pair
    jstate = jinit_opt_state(jparams, JAdamWConfig(lr=1e-3, warmup_steps=2))
    params = PM.params_from_jax(_np(jparams), device="cpu", dtype=None)
    state = PM.params_from_jax(_np(jstate), device="cpu", dtype=None)
    jstep = jax.jit(jmake_train_step(jmodel, JAdamWConfig(lr=1e-3, warmup_steps=2)))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    rng = np.random.default_rng(5)
    for i in range(3):
        toks, labels = (rng.integers(0, model.cfg.vocab, (2, 24)).astype(np.int32) for _ in "tl")
        jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(toks),
                                                      "labels": jnp.asarray(labels)})
        params, state, m = step(params, state, {"tokens": torch.from_numpy(toks).long(),
                                                "labels": torch.from_numpy(labels).long()})
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-4, (i, name)
    got, want = PM.tree_leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mla_prefill_matches_jax():
    """MLA's full-sequence attention (q and k of qk_nope + qk_rope channels, v
    of v_head_dim) through the plain flash version: last logits within 1e-4."""
    jmodel, jparams, model, params = _pair("deepseek-v2-lite-16b")
    toks = np.random.default_rng(8).integers(0, model.cfg.vocab, (2, 24), dtype=np.int32)
    jlogits = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_flash_kernel_refuses_mla_widths():
    """The card's flash wrapper takes MLA's widths (q and k of 192, v of 128),
    and at those widths refuses a v that does not fit k (other keys, other kv
    heads), a v wider than q and k, and q and k past 192: no plain version
    runs in the kernel's place."""
    m = ARCHS["deepseek-v2-lite-16b"].mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    q = torch.zeros(1, 16, 8, qk)
    v = torch.zeros(1, 16, 8, m.v_head_dim)
    kflash.check_args(q, q, v)
    assert (qk, m.v_head_dim) in kflash.TC_WIDTHS
    for bad in (torch.zeros(1, 16, 9, m.v_head_dim), torch.zeros(1, 8, 8, m.v_head_dim)):
        with pytest.raises(ValueError, match="expected"):
            kflash.check_args(q, q, bad)
    with pytest.raises(ValueError, match="v's hd 256 > q and k's 192"):
        kflash.check_args(q, q, torch.zeros(1, 16, 8, 256))
    wide = torch.zeros(1, 16, 8, qk + 8)
    with pytest.raises(ValueError, match="hd 200 > 192"):
        kflash.check_args(wide, wide, v)
