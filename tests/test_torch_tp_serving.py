"""Serving over the ``model`` axis in the port's DecoderLM, in one spawned
world of 4 CPU ranks (``gloo``) in fp32, against JAX's single-device
``prefill``, ``decode_step`` and ``ServingEngine`` on the same parameters.

Each case cuts a JAX parameter tree into every rank's shards
(``params_from_jax`` + ``shard_params``); a rank holds its rows over the
data axis and its slots of the cache (``init_cache``).  Held to JAX (logits
rtol = atol = 1e-4, as the port's single-device serving tests hold them):
``prefill``'s last logits; a teacher-forced run of ``decode_step`` from an
empty cache, every step's logits and greedy token, the early steps leaving
ranks with no visible slot; each rank's cache shard against the matching
slots of JAX's cache (``params.shard_cache``); ``ServingEngine.generate``
(greedy) equal to JAX's tokens on every rank; the logits bit-equal across
each model group.  The cases: (a) qwen-like (tied, the vocab divides, QKV
bias) at data 2 x model 2 and data 1 x model 4; (b) internvl2-like with a
vocab of 511 (a ``d_model`` cut) and image embeddings in the prefill;
(c) qwen3-like (qk-norm) whose kv heads the 4-way axis cuts inside a head,
and (c_q) queries cut inside a head too (6 heads); (d) deepseek-like MLA +
MoE (``layer0``, shared experts) at data 2 x model 2, routed over the data
axis, and (d_q) with 6 heads at data 1 x model 4 (every rank computes every
head); (e) mixtral-like with a window of 64, decoded to position 71 so the
ring wraps and the writing rank moves.  The world also counts one rank's
decode step and prefill against the dry-run's meta count of them.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import tp_serve_world
from _torch_tp_jax import configs
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.models.layers import ShardSlot, cache_shard_slot

TOL = dict(rtol=1e-4, atol=1e-4)
B = 4
#: name -> (arch, overrides, seed, meshes, cache_len, decoded tokens)
CASES = {
    "a": ("qwen1.5-0.5b", {}, 0, ((2, 2), (1, 4)), 16, 12),
    "b": ("internvl2-2b", {"vocab": 511}, 1, ((2, 2),), 16, 10),
    "c": ("qwen3-4b", {}, 2, ((1, 4),), 16, 10),
    "c_q": ("phi3-medium-14b", {"n_heads": 6}, 3, ((1, 4),), 16, 10),
    "d": ("deepseek-v2-lite-16b", {}, 4, ((2, 2),), 16, 10),
    "d_q": ("deepseek-v2-lite-16b", {"n_heads": 6}, 6, ((1, 4),), 16, 10),
    "e": ("mixtral-8x7b", {"sliding_window": 64}, 5, ((1, 4),), 64, 72),
}
PROMPT, NEW = 6, 6
PARAMS = [(c, m) for c, v in CASES.items() for m in v[3]]
#: the case and mesh whose decode step and prefill are counted real and on meta
COUNTED = ("a", (2, 2), 8, 16)


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (arch, over, seed, _, cache_len, L) in CASES.items():
        jcfg, cfg = configs(arch, **over)
        jparams = jax.tree.map(np.asarray, JPM.materialize(
            jbuild_model(jcfg, mesh=None).layout(), jax.random.PRNGKey(seed), jcfg.dtype))
        rng = np.random.default_rng(seed)
        inputs = {"tokens": rng.integers(0, jcfg.vocab, (B, L)).astype(np.int64),
                  "prompt": PROMPT, "new": NEW, "cache_len": cache_len, "img_emb": None}
        if jcfg.vlm is not None:
            inputs["img_emb"] = rng.normal(
                size=(B, jcfg.vlm.n_image_tokens, jcfg.d_model)).astype(np.float32)
        out[case] = (jcfg, cfg, jparams, inputs)
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("tp_serve")
    cases = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][3]) for c, m in PARAMS]
    case, mesh, b, s = COUNTED
    count_case = (_name(case, mesh), mesh, setup[case][1], setup[case][2], b, s)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_serve_world, 4, cases, count_case,
                          init_method=f"file://{root}/rendezvous", timeout=240.0)


def _jax_serve(jcfg, jparams: dict, inputs: dict) -> dict:
    """JAX's single-device prefill, teacher-forced decode steps from a zero
    cache (every step's logits, the cache at the end) and greedy engine."""
    model = jbuild_model(jcfg, mesh=None)
    params = jax.tree.map(jnp.asarray, jparams)
    tokens = inputs["tokens"]
    batch = {"tokens": jnp.asarray(tokens[:, :inputs["prompt"]], jnp.int32)}
    if inputs["img_emb"] is not None:
        batch["img_emb"] = jnp.asarray(inputs["img_emb"])
    prefill = np.asarray(jax.jit(model.prefill)(params, batch))
    cache = JPM.materialize(model.cache_layout(B, inputs["cache_len"]), jax.random.PRNGKey(0),
                            jcfg.dtype)
    decode = jax.jit(model.decode_step)
    steps = []
    for t in range(tokens.shape[1]):
        logits, cache = decode(params, {"tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                        "cache": cache, "index": jnp.asarray(t, jnp.int32)})
        steps.append(np.asarray(logits)[:, 0])
    generated = JServingEngine(model, params, cache_len=inputs["cache_len"], batch=B).generate(
        tokens[:, :inputs["prompt"]], JServeConfig(max_new_tokens=inputs["new"]))
    return {"prefill": prefill, "steps": np.stack(steps), "generated": np.asarray(generated),
            "cache": jax.tree.map(np.asarray, cache)}


@pytest.fixture(scope="module")
def oracle(setup, started):
    return {case: _jax_serve(jcfg, jparams, inputs)
            for case, (jcfg, _, jparams, inputs) in setup.items()}


@pytest.fixture(scope="module")
def world(started):
    return started.result()


def _rows(out) -> slice:
    return slice(*out["rows"])


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_prefill_matches_jax(case, mesh, oracle, world):
    want = oracle[case]["prefill"]
    for out in world:
        got = out[_name(case, mesh)]["prefill"]
        rows = want[_rows(out[_name(case, mesh)])]
        assert got.dtype == np.float32 and got.shape == rows.shape
        np.testing.assert_allclose(got, rows, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_teacher_forced_decode_matches_jax(case, mesh, setup, oracle, world):
    """Every step's logits and greedy token, from the first (where only rank 0
    of the axis sees a slot) to the last."""
    want = oracle[case]["steps"]
    cfg = setup[case][1]
    for out in world:
        res = out[_name(case, mesh)]
        got, ref = res["steps"], want[:, _rows(res)]
        assert got.shape == ref.shape and ref.shape[-1] == cfg.vocab
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_cache_shards_match_jax_slots(case, mesh, setup, oracle, world):
    """Each rank's shard of every cache leaf against its slots and rows of
    JAX's cache after the last step, cut by the same spec rules."""
    jcfg, cfg, _, inputs = setup[case]
    for rank, out in enumerate(world):
        abstract = AbstractMesh(mesh, ("data", "model"), rank=rank)
        model = build_model(cfg, model_axis=mesh[1], mesh=abstract, device="meta")
        layout = model.cache_layout(B, inputs["cache_len"])
        whole = PM.tree_map(lambda a: torch.from_numpy(np.array(a)), oracle[case]["cache"])
        want = PM.shard_cache(whole, layout, abstract)
        got = out[_name(case, mesh)]["cache"]
        for path, g, w, info in zip(PM._paths(got), PM.tree_leaves(got), PM.tree_leaves(want),
                                    PM.tree_leaves(layout)):
            assert g.shape == tuple(w.shape) != tuple(info.shape), path
            np.testing.assert_allclose(g, w.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_engine_generates_jax_tokens_on_every_rank(case, mesh, oracle, world):
    want = oracle[case]["generated"]
    for out in world:
        got = out[_name(case, mesh)]["generated"]
        assert got.dtype == np.int32 and got.shape == (B, NEW)
        np.testing.assert_array_equal(got, want)


def test_ranks_of_a_model_group_see_the_same_logits(world):
    for case, mesh in PARAMS:
        name = _name(case, mesh)
        for out in world:
            group = [o for o in world if o[name]["coords"]["data"] == out[name]["coords"]["data"]]
            assert len(group) == mesh[1]
            for other in group:
                np.testing.assert_array_equal(out[name]["steps"], other[name]["steps"])
                np.testing.assert_array_equal(out[name]["prefill"], other[name]["prefill"])


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_meta_count_equals_a_real_ranks_count(kind, world):
    """The dry-run counts one rank's tensor-parallel serving step on meta under
    an AbstractMesh (``train.step.tp_serve_costs``); a real CPU rank's step
    counts the same: FLOPs, traffic, kernel calls, collectives and the state
    it starts with."""
    for out in world:
        real, meta = out["count"][kind]["real"], out["count"][kind]["meta"]
        assert real == meta
        assert real["collectives"]["all_gather"]["calls"] > 0
        assert real["kernels"]["decode_attention" if kind == "decode"
                               else "flash_attention"]["calls"] == 2


@pytest.mark.parametrize("window,index,want", [
    (0, 0, ShardSlot(0, 0, (1, 0, 0, 0))),
    (0, 5, ShardSlot(1, 1, (4, 2, 0, 0))),
    (0, 15, ShardSlot(3, 3, (4, 4, 4, 4))),
    (16, 15, ShardSlot(3, 3, (4, 4, 4, 4))),
    (16, 16, ShardSlot(0, 0, (4, 4, 4, 4))),
    (16, 22, ShardSlot(1, 2, (4, 4, 4, 4))),
])
def test_cache_shard_slot(window, index, want):
    """The owner of the token's slot, its local slot and each rank's visible
    count of a cache of 16 slots over 4 ranks; a ring's writer moves with
    ``index % 16``."""
    assert cache_shard_slot(index, 16, window, 4) == want


def test_cache_shard_slot_refuses_what_jax_cannot_cut():
    with pytest.raises(ValueError, match="does not cut into 4"):
        cache_shard_slot(0, 18, 18, 4)
    with pytest.raises(IndexError):
        cache_shard_slot(16, 16, 0, 4)
