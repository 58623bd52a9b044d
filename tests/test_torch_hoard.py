"""The port's Hoard data plane on the CPU against the JAX package.

The same calls on both packages: ``build_cluster``, a materialised
``StripeStore.create``, reads through the store and through HoardFS, node
loss, repair and a corrupted replica.  Exact unless noted: the chunk files
and ``manifest.json`` texts are byte-equal, replica choices and read bytes
equal, and the simulated clock's ``now`` equal to the last bit on both flow
engines.  Then the store feeds training: bytes read through
``FileDataset.read_item_bytes`` drive one fp32 step of the port's smoke
qwen1.5-0.5b within 1e-5 of JAX's jitted step on the same batch, and both
launchers leave byte-equal chunk trees and read the seeded corpus's rows.
"""

import dataclasses
import filecmp
import json
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fs as JFS
import repro_torch.core as P
import repro_torch.fs as PFS
from repro.configs import ARCHS as JARCHS
from repro.launch import train as jax_train
from repro.models import params as JPM
from repro.models.registry import build_model as jbuild_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro.train import token_batch_from_bytes as jtoken_batch_from_bytes
from repro_torch.configs import ARCHS
from repro_torch.data import TokenDatasetSpec, read_items
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train import (
    AdamWConfig,
    init_opt_state,
    init_train_state,
    make_train_step,
    token_batch_from_bytes,
)

ENGINES = ["scalar", "vector"]
N_ITEMS, ITEM_BYTES, IPC = 96, 200, 8           # 12 chunks of 1600 B


def _tree_equal(a: Path, b: Path) -> None:
    """Every file under ``a`` and ``b`` byte-equal, with the same names."""
    names_a = sorted(p.relative_to(a).as_posix() for p in a.rglob("*") if p.is_file())
    names_b = sorted(p.relative_to(b).as_posix() for p in b.rglob("*") if p.is_file())
    assert names_a == names_b and names_a
    match, mismatch, errors = filecmp.cmpfiles(a, b, names_a, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _both(tmp_path, *, engine="vector", replication=1, nodes_per_rack=4):
    """The same cluster and materialised dataset ``ds`` in both packages."""
    out = {}
    for name, pkg in (("jax", J), ("port", P)):
        clock = pkg.SimClock(engine=engine)
        topo = pkg.Topology(pkg.TopologyConfig(nodes_per_rack=nodes_per_rack), clock)
        store = pkg.StripeStore(topo, root=str(tmp_path / name))
        cache = pkg.CacheManager(topo, store, clock, items_per_chunk=IPC,
                                 replication=replication)
        cache.register(pkg.DatasetSpec("ds", "nfs://store/ds", N_ITEMS, ITEM_BYTES))
        cache.admit("ds", topo.nodes[:4], materialize=True)
        cache.mark_filled("ds")
        out[name] = SimpleNamespace(pkg=pkg, clock=clock, topo=topo, store=store, cache=cache)
    return out["jax"], out["port"]


@pytest.mark.parametrize("replication", [1, 2])
def test_build_cluster_create_files_manifests_and_replica_choices(tmp_path, replication):
    for name, pkg in (("jax", J), ("port", P)):
        clock, topo, store, cache, engine = pkg.build_cluster(engine="scalar")
        store.root = str(tmp_path / name)
        store.create("ds", N_ITEMS, ITEM_BYTES, topo.nodes[:4], items_per_chunk=IPC,
                     replication=replication, materialize=True,
                     payload=lambda c: bytes([c % 251]) * (IPC * ITEM_BYTES))
        store.create("rnd", N_ITEMS, ITEM_BYTES, topo.nodes[:4], items_per_chunk=IPC,
                     replication=replication, materialize=True)
        if name == "jax":
            jtopo, jstore = topo, store
    _tree_equal(tmp_path / "jax", tmp_path / "port")
    for ds in ("ds", "rnd"):
        assert store.manifests[ds].to_json() == jstore.manifests[ds].to_json()
        text = (tmp_path / "port" / f"{ds}.manifest.json").read_text()
        assert text == (tmp_path / "jax" / f"{ds}.manifest.json").read_text()
        assert json.loads(text)["chunk_crc"] == jstore.manifests[ds].chunk_crc
    items = np.arange(N_ITEMS)
    for reader, jreader in zip(topo.nodes, jtopo.nodes):
        np.testing.assert_array_equal(store.locate_batch("rnd", items, reader),
                                      jstore.locate_batch("rnd", items, jreader))


def test_read_item_after_node_loss_repair_and_corruption(tmp_path):
    jx, pt = _both(tmp_path, replication=2, nodes_per_rack=2)

    def read_all(side, reader):
        return [side.store.read_item("ds", i, side.topo.nodes[reader]) for i in range(N_ITEMS)]

    for reader in range(len(pt.topo.nodes)):
        assert read_all(pt, reader) == read_all(jx, reader)
    for side in (jx, pt):
        side.store.fail_node(1)
    assert read_all(pt, 0) == read_all(jx, 0)
    assert pt.store.repair("ds") == jx.store.repair("ds") > 0
    assert pt.store.manifests["ds"].to_json() == jx.store.manifests["ds"].to_json()
    _tree_equal(tmp_path / "jax", tmp_path / "port")
    # flip one byte of the replica node 0 would read of chunk 0
    man = pt.store.manifests["ds"]
    victim = int(pt.store.locate("ds", 0, pt.topo.nodes[0]).node_id)
    assert victim == int(jx.store.locate("ds", 0, jx.topo.nodes[0]).node_id)
    for name in ("jax", "port"):
        path = tmp_path / name / f"node{victim}" / "ds" / "chunk_000000"
        raw = bytearray(path.read_bytes())
        raw[17] ^= 0xFF
        path.write_bytes(bytes(raw))
    got, want = read_all(pt, 0), read_all(jx, 0)
    assert got == want
    assert pt.store.corruption_repairs == jx.store.corruption_repairs == 1
    _tree_equal(tmp_path / "jax", tmp_path / "port")
    healed = (tmp_path / "port" / f"node{victim}" / "ds" / "chunk_000000").read_bytes()
    assert zlib.crc32(healed) == man.chunk_crc[0]


@pytest.mark.parametrize("engine", ENGINES)
def test_hoardfs_reads_and_clock_equal(tmp_path, engine):
    jx, pt = _both(tmp_path, engine=engine)
    out = {}
    for name, side, fsmod in (("jax", jx, JFS), ("port", pt, PFS)):
        fs = fsmod.HoardFS(side.clock, side.topo, side.cache, fsmod.MetadataService(side.store),
                           side.topo.nodes[0])
        fs.meta.set_items_per_file("ds", 24)            # 4 shard files
        assert fs.readdir("/hoard/ds") == ["shard-000000.bin", "shard-000001.bin",
                                           "shard-000002.bin", "shard-000003.bin"]
        fd = fs.open("/hoard/ds/shard-000001.bin")
        reads = [fs.pread(fd, n, off) for off, n in ((0, 200), (150, 900), (4000, 1000),
                                                      (4700, 500))]
        fd2 = fs.open("/hoard/ds/shard-000003.bin")
        ev = fs.pread_batch([fd, fd2, fd2], np.array([200, 0, 2200]))
        ds = fsmod.FileDataset(fs, "/hoard/ds")
        items = ds.read_item_bytes(np.array([5, 77, 30, 95, 0]))
        side.clock.run()
        assert ev.fired
        out[name] = ([r.data for r in reads], [r.data for r in items], side.clock.now)
        ds.close()
        fs.close(fd)
        fs.close(fd2)
    (jreads, jitems, jnow), (preads, pitems, pnow) = out["jax"], out["port"]
    assert preads == jreads and pitems == jitems
    assert all(d is not None for d in preads + pitems)
    assert [len(d) for d in preads] == [200, 900, 800, 100]      # the file ends at 4800
    assert pnow == jnow and pnow > 0


def test_compute_plane_step_from_hoardfs_bytes_matches_jax(tmp_path):
    """The port of tests/test_compute_plane.py's real-step path: int32 records
    read through ``FileDataset.read_item_bytes``, decoded, and one fp32 train
    step of the smoke qwen1.5-0.5b with JAX's weights: the loss within 1e-5."""
    seq_len, vocab, batch = 64, 512, 4
    item_bytes = seq_len * 4
    n_items, ipc = 1024, 64
    toks_per_chunk = ipc * seq_len
    payloads = {}
    for name, pkg, fsmod in (("jax", J, JFS), ("port", P, PFS)):
        cal = dataclasses.replace(pkg.PAPER, dataset_bytes=float(n_items * item_bytes),
                                  dataset_items=n_items, batch_items=batch)
        clock = pkg.SimClock(engine="vector")
        topo = pkg.Topology(pkg.TopologyConfig(nodes_per_rack=4), clock)
        store = pkg.StripeStore(topo, root=str(tmp_path / name))
        cache = pkg.CacheManager(topo, store, clock, items_per_chunk=ipc, fill_bw=cal.fill_bw)
        cache.register(pkg.DatasetSpec("ds", "nfs://store/ds", n_items, item_bytes))
        cache.admit("ds", topo.nodes[:4], materialize=True, payload=lambda c: np.arange(
            c * toks_per_chunk, (c + 1) * toks_per_chunk, dtype=np.int32).tobytes())
        cache.mark_filled("ds")
        fs = fsmod.HoardFS(clock, topo, cache, fsmod.MetadataService(store), topo.nodes[0],
                           cal=cal)
        fs.meta.set_items_per_file("ds", 256)
        ds = fsmod.FileDataset(fs, "/hoard/ds", cal=cal)
        results = ds.read_item_bytes(np.arange(batch))
        clock.run()
        payloads[name] = ([r.data for r in results], clock.now)
        ds.close()
    assert payloads["port"] == payloads["jax"]
    data = payloads["port"][0]
    assert data[1] == np.arange(seq_len, 2 * seq_len, dtype=np.int32).tobytes()

    batch_t = token_batch_from_bytes(data, seq_len, vocab, device="cpu")
    jbatch = jtoken_batch_from_bytes(data, seq_len, vocab)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(batch_t[k].numpy(), np.asarray(jbatch[k]))
    jcfg = JARCHS["qwen1.5-0.5b"].smoke()
    jmodel = jbuild_model(jcfg, model_axis=1)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    model = build_model(ARCHS["qwen1.5-0.5b"].smoke(), device="cpu")
    assert model.dtype == torch.float32
    params = PM.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu", dtype=None)
    _, _, jm = jax.jit(jmake_train_step(jmodel))(jparams, jopt, jbatch)
    new_params, _, m = make_train_step(model)(params, init_opt_state(params, AdamWConfig()),
                                              batch_t)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert all(torch.isfinite(t).all() for t in PM.tree_leaves(new_params))


def test_train_launchers_leave_equal_trees_and_read_the_corpus(tmp_path):
    """``--data-root`` on both launchers: byte-equal chunk trees and
    manifests; each port batch is the seeded corpus's rows at its ids, which
    follow the seeded epoch order, so the losses are those of the same loop
    fed those rows directly."""
    argv = ["--steps", "4", "--batch", "2", "--seq", "32", "--ckpt-every", "100"]
    res = port_train.main(argv + ["--device", "cpu", "--data-root", str(tmp_path / "A"),
                                  "--ckpt-dir", str(tmp_path / "ckA")])
    jax_train.main(argv + ["--data-root", str(tmp_path / "B"), "--ckpt-dir",
                           str(tmp_path / "ckB")])
    _tree_equal(tmp_path / "A", tmp_path / "B")
    assert res["data_root"] == str(tmp_path / "A") and res["materialize_seconds"] > 0
    assert len(res["load_ms"]) == len(res["step_ms"]) == 4
    assert all(0 < lo < st for lo, st in zip(res["load_ms"], res["step_ms"]))
    model = build_model(ARCHS["qwen1.5-0.5b"].smoke(), device="cpu")
    spec = TokenDatasetSpec("train-corpus", n_sequences=256, seq_len=32, vocab=model.cfg.vocab,
                            seed=0)
    order = np.random.default_rng((0, 0)).permutation(256)
    # the loop as it ran before the store fed it: the seeded rows, read directly
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0), opt_cfg)
    step = make_train_step(model, opt_cfg)
    for s, (ids, crc) in enumerate(zip(res["batch_ids"], res["batch_crc32"])):
        assert ids == order[2 * s: 2 * s + 2].tolist()
        toks = read_items(spec, ids, items_per_chunk=16)
        assert crc == zlib.crc32(toks.tobytes())
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks).long(),
                                            "labels": torch.from_numpy(labels).long()})
        assert float(m["loss"]) == res["losses"][s]


def test_serve_launcher_reads_prompts_from_the_store():
    """The prompts are read through the stripe store, equal the seeded
    corpus's rows, and generate what the engine generates from those rows."""
    res = port_serve.main(["--device", "cpu", "--requests", "3", "--prompt-len", "8",
                           "--new-tokens", "4"])
    model = build_model(ARCHS["qwen1.5-0.5b"].smoke(), device="cpu")
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=8, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(3), items_per_chunk=port_serve.PROMPT_ITEMS_PER_CHUNK)
    np.testing.assert_array_equal(res["prompts"], prompts)
    params = model.init_params(torch.Generator().manual_seed(0))
    want = ServingEngine(model, params, cache_len=20, batch=3).generate(
        prompts, ServeConfig(max_new_tokens=4, temperature=0.0, seed=0))
    np.testing.assert_array_equal(np.asarray(res["tokens"]), np.asarray(want))
