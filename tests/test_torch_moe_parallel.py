"""Data-parallel MoE and experts over the ``model`` axis in the port's
DecoderLM, in one spawned world of 4 CPU ranks (``gloo``) in fp32, against
JAX's single-device ``make_train_step`` on the global batch.

JAX routes the global batch: ``C = ceil(N_global k / E * cf)``, a pair's
slot is its place in the global token-major queue, and the aux loss is a
product of global means.  The port's ranks route their own rows with those
semantics (``layers.moe_route`` over the data axes).  The cases, each held to
JAX's loss (1e-5), gradients (1e-4 of each leaf's largest entry), update
(1e-6) and ``grad_norm``, with every replicated leaf bit-equal across each
model group: (d) deepseek-like (MLA, a dense ``layer0``, 2 shared experts)
whose 4 experts the axis divides (expert parallelism) at data 1 x model 4
and data 2 x model 2; (e) mixtral-like with 3 experts, split inside every
expert, at data 2 x model 2 and data 1 x model 4; (f) mixtral-like at a
capacity factor of 0.5 at data 4 x model 1 and data 2 x model 2: pairs are
dropped, each layer's dropped count summed over the data ranks equals
JAX's, and routing each rank's rows with a capacity of its own would keep
other pairs.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

from _torch_ranks import tp_world
from _torch_tp_jax import case_inputs, check_against_jax, configs, jax_dropped, jax_step
from repro_torch.launch.mesh import run_ranks

#: name -> (arch, overrides, seed, meshes)
CASES = {
    "d": ("deepseek-v2-lite-16b", {}, 4, ((1, 4), (2, 2))),
    "e": ("mixtral-8x7b", {"n_experts": 3}, 5, ((2, 2), (1, 4))),
    "f": ("mixtral-8x7b", {"capacity_factor": 0.5}, 6, ((4, 1), (2, 2))),
}
PARAMS = [(c, m) for c, v in CASES.items() for m in v[3]]


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (arch, over, seed, _) in CASES.items():
        jcfg, cfg = configs(arch, **over)
        out[case] = (jcfg, cfg, *case_inputs(jcfg, seed))
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("moe_tp")
    cases = [(_name(case, mesh), mesh, setup[case][1], setup[case][2], setup[case][3], 1)
             for case, mesh in PARAMS]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_world, 4, cases, "",
                          init_method=f"file://{root}/rendezvous", timeout=120.0)


@pytest.fixture(scope="module")
def oracle(setup, started):
    return {case: jax_step(jcfg, jparams, batch)
            for case, (jcfg, _, jparams, batch) in setup.items()}


@pytest.fixture(scope="module")
def world(started):
    return started.result()


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_step_matches_jax_single_device_step(case, mesh, setup, oracle, world):
    check_against_jax([o[_name(case, mesh)] for o in world], oracle[case], setup[case][2])


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_expert_leaves_follow_expert_specs(case, mesh, setup, world):
    """E divisible: each rank holds E/tp whole experts; otherwise every expert
    with F/tp columns of its gate and up products and rows of its down."""
    cfg = setup[case][1]
    E, F, tp = cfg.moe.n_experts, cfg.moe.d_expert, mesh[1]
    shapes = world[0][_name(case, mesh)]["shapes"]
    if E % tp == 0:
        assert shapes["layers/mlp/w_gate"][1:] == (E // tp, cfg.d_model, F)
        assert shapes["layers/mlp/w_down"][1:] == (E // tp, F, cfg.d_model)
    else:
        assert shapes["layers/mlp/w_gate"][1:] == (E, cfg.d_model, F // tp)
        assert shapes["layers/mlp/w_down"][1:] == (E, F // tp, cfg.d_model)
    assert shapes["layers/mlp/router"][1:] == (cfg.d_model, E)


@pytest.mark.parametrize("mesh", CASES["f"][3])
def test_global_capacity_drops_what_jax_drops(mesh, setup, oracle, world, monkeypatch):
    jcfg, cfg, jparams, batch = setup["f"]
    want = jax_dropped(monkeypatch, jcfg, jparams, batch)
    outs = [o[_name("f", mesh)] for o in world]
    heads = [o for o in outs if o["coords"]["model"] == 0]
    assert len(heads) == mesh[0] and len(want) == cfg.n_layers
    got = [sum(o["dropped"][i] for o in heads) for i in range(cfg.n_layers)]
    assert got == want and sum(want) > 0
    assert all(o["aux"] == outs[0]["aux"] for o in outs)
    assert abs(outs[0]["aux"] - oracle["f"]["aux"]) <= 1e-6
    # rank-local capacity (each rank's rows alone) would keep other pairs
    assert any(any(o["local_routing_differs"]) for o in heads)
