"""Hoard's scenario engine in the port against the JAX package's.

``core/workload.py``, ``core/rebalance.py`` and ``core/cluster.py``'s
``ScenarioConfig`` / ``run_scenario`` are copied bit for bit, so the same
scenario gives the same floats: ``epoch_times`` and ``stall_breakdown`` of
every job, for the ``hoard`` and ``posix`` backends, ``prepopulated`` and
``ondemand`` fills, and ``ConstantCompute`` and a ``RooflineCompute``
(one of the port's H100 table, one with a step time given).  A rebalance
(a node joins, another fails) gives the same moves, manifests and clock.
"""

import dataclasses

import pytest

import repro.core as J
import repro_torch.core as T

N_ITEMS, ITEM_B = 1024, 1024


def _cal(pkg):
    return dataclasses.replace(pkg.PAPER, dataset_bytes=float(N_ITEMS * ITEM_B),
                               dataset_items=N_ITEMS, batch_items=128)


def _compute(pkg, kind: str):
    if kind == "constant":
        return pkg.ConstantCompute(_cal(pkg))
    if kind == "measured":
        return pkg.RooflineCompute(arch="qwen1.5-0.5b", shape="train", mesh="1x1",
                                   step_s=0.0123, items_per_step=8)
    if pkg is J:
        # the same cell's price, read from the port's table, given to both
        cell = T.RooflineCompute.from_roofline("qwen1.5-0.5b", "train_4k", "16x16")
        return J.RooflineCompute(cell.arch, cell.shape, cell.mesh, cell.step_s,
                                 cell.items_per_step, cell.bottleneck)
    return T.RooflineCompute.from_roofline("qwen1.5-0.5b", "train_4k", "16x16")


def _run(pkg, backend: str, fill: str, compute: str):
    return pkg.run_scenario(pkg.ScenarioConfig(
        backend=backend, epochs=2, n_jobs=2, cal=_cal(pkg), fill=fill, mdr=0.5,
        compute=_compute(pkg, compute)))


@pytest.mark.parametrize("compute", ["constant", "h100_table", "measured"])
@pytest.mark.parametrize("fill", ["prepopulated", "ondemand"])
@pytest.mark.parametrize("backend", ["hoard", "posix"])
def test_scenario_equals_jax(backend, fill, compute):
    want = _run(J, backend, fill, compute)
    got = _run(T, backend, fill, compute)
    assert len(got.jobs) == len(want.jobs) == 2
    for jg, jw in zip(got.jobs, want.jobs):
        assert jg.epoch_times == jw.epoch_times
        assert jg.stall_breakdown == jw.stall_breakdown
    assert got.sim_seconds == want.sim_seconds
    assert got.mean_epoch_times == want.mean_epoch_times


def test_roofline_compute_prices_the_step_it_was_given():
    got = _run(T, "hoard", "prepopulated", "measured")
    steps = _cal(T).steps_per_epoch
    for job in got.jobs:
        # 0.0123 s for 8 items, so 128 items a step cost 16 x that
        assert job.stall_breakdown["compute"] == pytest.approx(0.0123 * 16 * steps * 2)


def _rebalanced(pkg):
    clock = pkg.SimClock()
    topo = pkg.Topology(pkg.TopologyConfig(nodes_per_rack=8), clock)
    store = pkg.StripeStore(topo)
    cache = pkg.CacheManager(topo, store, clock, capacity_per_node=1e9, items_per_chunk=4,
                             replication=2)
    cache.register(pkg.DatasetSpec("ds", "nfs://ds", 400, 100))
    rb = pkg.Rebalancer(clock, topo, cache, members=(0, 1, 2, 3), migration_bw=8000.0)
    cache.admit("ds", topo.nodes[:4])
    cache.mark_filled("ds")
    joined = rb.add_node(4)
    clock.run()
    failed = rb.fail_node(1)
    clock.run()
    man = store.manifests["ds"]
    return {"fired": (joined.fired, failed.fired), "epoch": rb.epoch.value, "now": clock.now,
            "moved": [p.committed_bytes for p in rb.plans], "nodes": list(man.node_ids),
            "chunks": [list(r) for r in man.chunk_nodes],
            "membership_epoch": man.membership_epoch}


def test_rebalance_equals_jax():
    want, got = _rebalanced(J), _rebalanced(T)
    assert got == want
    assert got["epoch"] == 2 and all(got["fired"])
