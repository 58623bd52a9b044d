"""The port's checkpoints through HoardFS on the CPU against the JAX package.

``HoardCheckpointManager`` writes JAX's format: for an fp32 state carried
across from JAX the payload bytes equal JAX's ``_encode`` payload exactly,
and the trailer manifests are equal but for ``treedef`` and the port's added
``leaf_dtypes``.  Save, restore and ``latest_step`` round-trip bit for bit
(bf16 leaves included), slots rotate, and a writer node lost mid-save leaves
the previous committed step, restored by a survivor.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fs as JFS
import repro_torch.core as P
import repro_torch.fs as PFS
from repro.configs import ARCHS as JARCHS
from repro.models import params as JPM
from repro.models.registry import build_model as jbuild_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import HoardCheckpointManager as JHoardCheckpointManager
from repro.train import SamplerState as JSamplerState
from repro.train import init_opt_state as jinit_opt_state
from repro_torch.models import params as PM
from repro_torch.train import HoardCheckpointManager, SamplerState

CAL = dataclasses.replace(J.PAPER, dataset_bytes=1024 * 1024.0, dataset_items=1024,
                          batch_items=128)
IPC = 64
IB = int(CAL.item_bytes)


def _cluster(pkg, fsmod, root, *, n_items=CAL.dataset_items, per_file=None):
    """A 4-node cluster with a filled dataset ``ckpt`` of ``n_items`` 1 KiB
    items at replication 2: by default 1 MiB, in 16 slots of 64 KiB."""
    clock = pkg.SimClock(engine="vector")
    topo = pkg.Topology(pkg.TopologyConfig(nodes_per_rack=4), clock)
    store = pkg.StripeStore(topo, root=str(root))
    cache = pkg.CacheManager(topo, store, clock, items_per_chunk=IPC, fill_bw=CAL.fill_bw,
                             replication=2)
    cache.register(pkg.DatasetSpec("ckpt", "nfs://store/ckpt", n_items, IB))
    cache.admit("ckpt", topo.nodes, materialize=True)
    cache.mark_filled("ckpt")
    meta = fsmod.MetadataService(store)
    if per_file:
        meta.set_items_per_file("ckpt", per_file)

    def mount(node):
        return fsmod.HoardFS(clock, topo, cache, meta, topo.nodes[node], cal=CAL)
    return clock, store, mount


@pytest.fixture(scope="module")
def jax_state():
    """The smoke qwen1.5-0.5b's fp32 params and AdamW state, as JAX holds them."""
    jcfg = JARCHS["qwen1.5-0.5b"].smoke()
    jcfg = dataclasses.replace(jcfg, n_layers=1, vocab=64)
    jmodel = jbuild_model(jcfg, model_axis=1)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    return jparams, jinit_opt_state(jparams, JAdamWConfig())


def _port(tree):
    return PM.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu", dtype=None)


def _state(tag: int):
    """A mixed-dtype state: fp32, bf16, int32 and a 0-d fp64 leaf."""
    params = {"w": (torch.arange(48, dtype=torch.float32) * (tag + 1)).reshape(6, 8),
              "e": (torch.linspace(-3, 3, 40) * (tag + 1)).to(torch.bfloat16).reshape(5, 8)}
    opt = {"m": torch.arange(8, dtype=torch.int32) + tag,
           "t": torch.tensor(tag / 3, dtype=torch.float64)}
    return params, opt


def _assert_equal(got, want):
    for g, w in zip(PM.tree_leaves(got), PM.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_payload_and_manifest_equal_jax(jax_state, tmp_path):
    jparams, jopt = jax_state
    params, opt = _port(jparams), _port(jopt)
    sampler = SamplerState(epoch=1, step_in_epoch=7, seed=3)
    _, _, pmount = _cluster(P, PFS, tmp_path / "port", n_items=4096, per_file=4096)
    _, _, jmount = _cluster(J, JFS, tmp_path / "jax", n_items=4096, per_file=4096)
    mgr = HoardCheckpointManager(pmount(0), "ckpt")
    jmgr = JHoardCheckpointManager(jmount(0), "ckpt")
    payload, trailer, manifest = mgr._encode(7, params, opt, sampler=sampler,
                                             config_digest="d1", mesh_shape=None)
    jpayload, jtrailer, jmanifest = jmgr._encode(7, jparams, jopt, sampler=JSamplerState(1, 7, 3),
                                                 config_digest="d1", mesh_shape=None)
    assert payload == jpayload
    assert manifest["leaf_dtypes"] == ["int32"] + ["float32"] * (manifest["n_leaves"] - 1)
    strip = ("treedef", "leaf_dtypes")
    assert ({k: v for k, v in manifest.items() if k not in strip}
            == {k: v for k, v in jmanifest.items() if k not in strip})
    assert trailer[-8:] == jtrailer[-8:] == b"HOARDCK1"
    assert trailer[-24:-16] == jtrailer[-24:-16] == len(payload).to_bytes(8, "big")

    assert mgr.save(7, params, opt, sampler=sampler) == "/hoard/ckpt/shard-000000.bin"
    assert mgr.latest_step() == 7
    step, p, o, s = mgr.restore(template={"params": params, "opt": opt})
    assert (step, s) == (7, sampler)
    _assert_equal({"params": p, "opt": o}, {"params": params, "opt": opt})


def test_save_restore_latest_step_and_rotation(tmp_path):
    _, _, mount = _cluster(P, PFS, tmp_path)
    mgr = HoardCheckpointManager(mount(0), "ckpt")
    assert mgr.keep == 16 and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(template={"params": {}, "opt": {}})
    for step in (1, 2, 1 + mgr.keep):               # step 17 overwrites slot 1
        p, o = _state(step)
        mgr.save(step, p, o, sampler=SamplerState(0, step, 5), config_digest="x")
    assert mgr.latest_step() == 1 + mgr.keep
    template = {"params": _state(0)[0], "opt": _state(0)[1]}
    step, p, o, s = HoardCheckpointManager(mount(3), "ckpt").restore(template=template)
    assert (step, s) == (17, SamplerState(0, 17, 5))
    _assert_equal({"params": p, "opt": o}, dict(zip(("params", "opt"), _state(17))))
    step, p, o, _ = mgr.restore(2, template=template, device="cpu")
    assert step == 2 and p["e"].dtype == torch.bfloat16
    _assert_equal({"params": p, "opt": o}, dict(zip(("params", "opt"), _state(2))))
    with pytest.raises(ValueError, match="larger"):
        mgr.save(3, {"w": torch.zeros(IPC * IB)}, {})


def test_writer_lost_mid_save_leaves_previous_step(tmp_path):
    """Node 0 fails while its save of step 3 is in flight (as
    tests/test_hoardckpt.py kills the writer for JAX): the save reports
    failure, and a survivor sees and restores step 2 bit for bit."""
    clock, store, mount = _cluster(P, PFS, tmp_path)
    mgr = HoardCheckpointManager(mount(0), "ckpt")
    mgr.save(1, *_state(1))
    mgr.save(2, *_state(2), sampler=SamplerState(0, 2, 7))
    ev = mgr.save(3, *_state(3), blocking=False)
    clock.schedule(0.0, lambda: store.fail_node(0))
    clock.run()
    assert ev.value is None
    survivor = HoardCheckpointManager(mount(2), "ckpt")
    assert survivor.latest_step() == 2
    template = dict(zip(("params", "opt"), _state(0)))
    step, p, o, s = survivor.restore(template=template)
    assert (step, s) == (2, SamplerState(0, 2, 7))
    _assert_equal({"params": p, "opt": o}, dict(zip(("params", "opt"), _state(2))))
