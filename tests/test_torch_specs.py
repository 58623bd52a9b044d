"""The port's sharding specs against the JAX package's, for every arch.

``params.specs`` of each model's ``layout()`` and ``cache_layout(...)`` at
``model_axis`` 16, 2 and 1, and ``opt_state_specs`` (the ZeRO-1 layout) on
stand-in meshes that carry only ``shape`` and ``axis_names``, as JAX's
``opt_state_specs`` reads them: no device and no process group is needed.
A JAX ``PartitionSpec`` compares as the tuple of its entries.
"""

from types import SimpleNamespace

import pytest

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.models.registry import WHISPER_DECODE_ENC_LEN
from repro.models.registry import _batch_spec as j_batch_spec
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import opt_state_specs as jopt_state_specs
from repro.train.optimizer import zero_spec_for as jzero_spec_for
from repro_torch.configs import ARCHS
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.models.registry import _batch_spec
from repro_torch.train import AdamWConfig, opt_state_specs, zero_spec_for

MESHES = {
    "data16_model16": {"data": 16, "model": 16},
    "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
    "data2_model1": {"data": 2, "model": 1},
}


def _mesh(shape: dict) -> SimpleNamespace:
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _plain(tree):
    """A JAX spec tree as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def _cache_specs(model, cfg):
    args = (8, 64, WHISPER_DECODE_ENC_LEN) if cfg.family == "encdec" else (8, 64)
    return model.cache_layout(*args)


@pytest.mark.parametrize("model_axis", [16, 2, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_match_jax(arch, model_axis):
    jmodel = jbuild_model(JARCHS[arch], model_axis=model_axis)
    model = build_model(ARCHS[arch], model_axis=model_axis, device="cpu")
    assert PM.specs(model.layout()) == _plain(JPM.specs(jmodel.layout()))
    assert PM.specs(_cache_specs(model, ARCHS[arch])) == \
        _plain(JPM.specs(_cache_specs(jmodel, JARCHS[arch])))
    # a mesh with neither pod nor data shards no cache dimension on the batch
    for axes in ({"data": 2, "model": model_axis}, {"model": model_axis}):
        mesh = _mesh(axes)
        jm = jbuild_model(JARCHS[arch], model_axis=model_axis, mesh=mesh)
        m = build_model(ARCHS[arch], model_axis=model_axis, mesh=mesh, device="cpu")
        assert PM.specs(_cache_specs(m, ARCHS[arch])) == \
            _plain(JPM.specs(_cache_specs(jm, JARCHS[arch])))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_match_jax(arch, mesh_name):
    shape = MESHES[mesh_name]
    mesh = _mesh(shape)
    jlayout = jbuild_model(JARCHS[arch], model_axis=shape["model"]).layout()
    layout = build_model(ARCHS[arch], model_axis=shape["model"], device="cpu").layout()
    for master in (True, False):
        want = _plain(jopt_state_specs(jlayout, mesh, JAdamWConfig(master_fp32=master)))
        got = opt_state_specs(layout, mesh, AdamWConfig(master_fp32=master))
        assert got == want
    # ZeRO shards the leaves of qwen1.5-0.5b at data 2 on some dimension each
    if arch == "qwen1.5-0.5b" and mesh_name == "data2_model1":
        assert all("data" in s for s in PM.tree_leaves(got["mu"]))


@pytest.mark.parametrize("case", [
    ((), (24, 1024, 2816), 2), ((None, "model"), (1024, 2816), 16),
    (("model", None), (151936, 1024), 16), (("model", None), (151936, 1024), 2),
    ((None,), (7,), 2), ((None, None), (3, 5), 4), ((None,), (8,), 0), ((), (), 4),
    ((None, None, "model"), (1, 16, 64), 16), ((None, "model", None), (2, 8, 6), 3),
])
def test_zero_spec_for_matches_jax(case):
    from jax.sharding import PartitionSpec as JP

    spec, shape, data = case
    assert zero_spec_for(PM.P(*spec), shape, data) == tuple(jzero_spec_for(JP(*spec), shape,
                                                                           data))


@pytest.mark.parametrize("mesh_shape", [None, {"data": 2, "model": 1},
                                        {"pod": 2, "data": 2, "model": 1},
                                        {"data": 3, "model": 1}, {"model": 4}])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_batch_spec_matches_jax(mesh_shape, batch):
    mesh = None if mesh_shape is None else _mesh(mesh_shape)
    assert _batch_spec(mesh, batch, None) == tuple(j_batch_spec(mesh, batch, None))
