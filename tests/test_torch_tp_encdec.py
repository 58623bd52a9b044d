"""Tensor-parallel training and serving of the port's encoder-decoder
(Whisper) over the ``model`` axis, in one spawned world of 4 CPU ranks
(``gloo``) in fp32, against JAX's single-device ``make_train_step``,
``prefill``, ``decode_step`` and ``ServingEngine`` on the same parameters
(``tests/_torch_tp_jax.py``).

The cases: (s) the smoke config (4 heads, a vocab of 512, 2 + 2 layers) at
data 2 x model 2 and data 1 x model 4 (each rank's own heads, the tied
unembedding vocab-parallel); (q) 6 heads and a vocab of 511 at data 1 x
model 4 (heads cut inside a head, so every rank computes every head; the
embedding cut on d, the tied unembedding a row-parallel product).  Each
batch holds 32 encoder frames.  Training: the loss, the synced gradient
gathered whole and the parameters after the step within ``TOL``, replicated
leaves bit-equal in each model group.  Serving: the prefill's and every
teacher-forced decode step's logits within 1e-4 of JAX's, the decode's cross
cache filled from the encoder's output of the frames (``EncDecLM.
fill_cross``: each rank's frames of every head), every cache shard equal to
JAX's slots, the engine's tokens (a zero cross cache, as JAX's engine
decodes) JAX's on every rank.  A rank's train step, decode step and prefill
count the same on meta as real.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_ranks import tp_family_world
from _torch_tp_jax import FRAMES, case_inputs, check_against_jax, configs, jax_serve, jax_step
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM

WHISPER = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)
B = 4
#: name -> (overrides, seed, meshes)
CASES = {
    "s": ({}, 0, ((2, 2), (1, 4))),
    "q": ({"vocab": 511, "n_heads": 6, "n_kv_heads": 6}, 1, ((1, 4),)),
}
PARAMS = [(c, m) for c, v in CASES.items() for m in v[2]]
#: serving: a self cache of 16 slots, 12 tokens decoded teacher-forced, the
#: engine's 6 new tokens after a prompt of 6
CACHE, DECODED, PROMPT, NEW = 16, 12, 6, 6
#: the case whose train step, decode step (a cache of 16) and prefill are counted
COUNTED = ("s", (2, 2), 8, 16)


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (over, seed, _) in CASES.items():
        jcfg, cfg = configs(WHISPER, **over)
        jparams, batch = case_inputs(jcfg, seed)
        rng = np.random.default_rng(seed + 10)
        serve = {"tokens": rng.integers(0, jcfg.vocab, (B, DECODED)).astype(np.int64),
                 "prompt": PROMPT, "new": NEW, "cache_len": CACHE,
                 "enc_emb": rng.normal(size=(B, FRAMES, jcfg.d_model)).astype(np.float32)}
        out[case] = (jcfg, cfg, jparams, batch, serve)
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("tp_encdec")
    train = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][3]) for c, m in PARAMS]
    serve = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][4]) for c, m in PARAMS]
    case, mesh, b, s = COUNTED
    count = (mesh, setup[case][1], setup[case][2], setup[case][3], b, s)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_family_world, 4, train, serve, count,
                          init_method=f"file://{root}/rendezvous", timeout=240.0)


@pytest.fixture(scope="module")
def oracle(setup, started):
    return {case: {"train": jax_step(jcfg, jparams, batch),
                   "serve": jax_serve(jcfg, jparams, serve, B)}
            for case, (jcfg, _, jparams, batch, serve) in setup.items()}


@pytest.fixture(scope="module")
def world(started):
    return started.result()


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_step_matches_jax_single_device_step(case, mesh, setup, oracle, world):
    name = _name(case, mesh)
    check_against_jax([o[name] for o in world], oracle[case]["train"], setup[case][2])
    # the case really cut the leaves the spec cuts on the model axis
    assert any(s != tuple(w.shape) for s, w in zip(world[0][name]["shapes"].values(),
                                                   PM.tree_leaves(oracle[case]["train"]["grads"])))


def test_shards_follow_the_specs(setup, world):
    """Column-parallel q, k, v and the MLP's input with their biases, row-
    parallel o and the MLP's output; the embedding cut on vocab where it
    divides the axis, on d at a vocab of 511."""
    cfg = setup["s"][1]
    D, F, V, H = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads * cfg.resolved_head_dim
    for tp in (2, 4):
        shapes = world[0][f"s@{4 // tp}x{tp}"]["shapes"]
        assert shapes["embed"] == (V // tp, D)
        for side in ("dec_layers/cross_attn", "dec_layers/self_attn", "enc_layers/attn"):
            assert shapes[f"{side}/wq"][-1] * tp == H == shapes[f"{side}/bq"][-1] * tp
            assert shapes[f"{side}/wo"][-2] * tp == H and shapes[f"{side}/bo"][-1] == D
        assert shapes["dec_layers/mlp/w_in"][-1] == F // tp == shapes["dec_layers/mlp/b_in"][-1]
        assert shapes["dec_layers/mlp/w_out"][-2] == F // tp
    assert world[0]["q@1x4"]["shapes"]["embed"] == (511, cfg.d_model // 4)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_prefill_matches_jax(case, mesh, oracle, world):
    want = oracle[case]["serve"]["prefill"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        rows = want[slice(*res["rows"])]
        assert res["prefill"].dtype == np.float32 and res["prefill"].shape == rows.shape
        np.testing.assert_allclose(res["prefill"], rows, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_teacher_forced_decode_matches_jax(case, mesh, oracle, world):
    """Every step's logits and greedy token over the cross cache of the
    encoder's output, from the first step (only rank 0 of the axis sees a
    self slot) to the last."""
    want = oracle[case]["serve"]["steps"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        got, ref = res["steps"], want[:, slice(*res["rows"])]
        assert got.shape == ref.shape and got.shape[0] == DECODED
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_cache_shards_match_jax_slots(case, mesh, setup, oracle, world):
    """Each rank's shard of the self and the cross K and V against its slots
    (frames) and rows of JAX's cache after the last step."""
    cfg = setup[case][1]
    whole = PM.tree_map(lambda a: torch.from_numpy(np.array(a)), oracle[case]["serve"]["cache"])
    for rank, out in enumerate(world):
        abstract = AbstractMesh(mesh, ("data", "model"), rank=rank)
        model = build_model(cfg, model_axis=mesh[1], mesh=abstract, device="meta")
        layout = model.cache_layout(B, CACHE, FRAMES)
        want = PM.shard_cache(whole, layout, abstract)
        got = out[f"serve_{_name(case, mesh)}"]["cache"]
        assert got["layers"]["cross_k"].shape[3] == FRAMES // mesh[1]
        for path, g, w, info in zip(PM._paths(got), PM.tree_leaves(got), PM.tree_leaves(want),
                                    PM.tree_leaves(layout)):
            assert g.shape == tuple(w.shape) != tuple(info.shape), path
            np.testing.assert_allclose(g, w.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_engine_generates_jax_tokens_on_every_rank(case, mesh, oracle, world):
    want = oracle[case]["serve"]["generated"]
    for out in world:
        got = out[f"serve_{_name(case, mesh)}"]["generated"]
        assert got.dtype == np.int32 and got.shape == (B, NEW)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_meta_count_equals_a_real_ranks_count(kind, world):
    """The dry-run counts one rank's tensor-parallel train step, decode step
    and prefill on meta under an AbstractMesh; a real CPU rank's count is the
    same: FLOPs, traffic, kernel calls, collectives, the state it starts with."""
    kernel, calls = {"train": ("flash_attention_bwd", 6), "decode": ("decode_attention", 4),
                     "prefill": ("flash_attention", 6)}[kind]
    for out in world:
        real, meta = out["count"][kind]["real"], out["count"][kind]["meta"]
        assert real == meta
        assert real["collectives"]["all_reduce"]["calls"] > 0
        assert real["kernels"][kernel]["calls"] == calls
