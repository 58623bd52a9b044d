"""The port's two-level gradient sync in a spawned world of 8 CPU ranks
(``gloo``), mesh pod 2 x data 2 x model 2 as in JAX's test, against JAX's
``compress_int8`` / ``decompress_int8`` for each pod.

Each rank's gradients are multiples of 2^-8, so the ``data`` means are exact
in fp32 and the int8 rounding sees the same values on both sides; the pod
mean is held within 1e-6.  One world runs every check (``world`` fixture,
rendezvous through a file under ``tmp_path``, at most 90 s).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import die_apart, sync_grads, sync_world
from repro.train.optimizer import compress_int8 as jcompress_int8
from repro.train.optimizer import decompress_int8 as jdecompress_int8
from repro_torch.launch.mesh import Mesh, make_test_mesh, run_ranks

SHAPES = {"b": (8,), "w": (16, 8)}
WORLD = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('sync')}/rendezvous"
    return run_ranks(sync_world, WORLD, SHAPES, init_method=init, timeout=90.0)


def _grads(pod, data, model):
    return sync_grads({"pod": pod, "data": data, "model": model}, SHAPES, 0)


def _jax_sync(coords, errors):
    """The expected compressed sync of the rank at ``coords``: per pod, the
    data mean, JAX's int8 round trip with ``errors[pod]``; then the pod mean."""
    m = coords["model"]
    deq, new_err = {}, {}
    for pod in (0, 1):
        for k in SHAPES:
            g = (_grads(pod, 0, m)[k] + _grads(pod, 1, m)[k]) / np.float32(2)
            q, scale, e = jcompress_int8(jnp.asarray(g), jnp.asarray(errors[pod][k]))
            deq[pod, k] = np.asarray(jdecompress_int8(q, scale))
            new_err[pod, k] = np.asarray(e)
    synced = {k: (deq[0, k] + deq[1, k]) / np.float32(2) for k in SHAPES}
    return synced, {pod: {k: new_err[pod, k] for k in SHAPES} for pod in (0, 1)}


def test_compressed_sync_matches_jax_per_pod(world):
    for out in world:
        c = out["coords"]
        zero = {pod: {k: np.zeros(s, np.float32) for k, s in SHAPES.items()} for pod in (0, 1)}
        want1, err1 = _jax_sync(c, zero)
        want2, err2 = _jax_sync(c, err1)
        for k in SHAPES:
            np.testing.assert_allclose(out["synced1"][k], want1[k], rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["errors1"][k], err1[c["pod"]][k], rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["synced2"][k], want2[k], rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["errors2"][k], err2[c["pod"]][k], rtol=0, atol=1e-6)
            assert out["synced1"][k].dtype == np.float32
        assert out["inputs_kept"]


def test_identical_inputs_keep_value_and_capture_residual(world):
    """JAX's own assertions (tests/test_elastic.py::test_two_level_grad_sync_int8)."""
    for out in world:
        assert out["identical_rel_err"] < 0.02
        assert out["identical_residual"] > 0


def test_plain_sync_is_the_mean_over_data_and_pod(world):
    for out in world:
        m = out["coords"]["model"]
        for k in SHAPES:
            want = sum(_grads(p, d, m)[k] for p in (0, 1) for d in (0, 1)) / np.float32(4)
            np.testing.assert_allclose(out["plain"][k], want, rtol=0, atol=1e-6)
        assert out["plain_errors_same"]


def test_bf16_leaf_is_summed_in_fp32_and_rounded_once(world):
    """A deliberate difference from JAX's pmean, which keeps bf16 throughout."""
    for out in world:
        assert out["bf16_dtype"] == "torch.bfloat16"
        group = [o for o in world if o["coords"]["model"] == out["coords"]["model"]]
        total = np.sum([o["bf16_in"] for o in group], axis=0, dtype=np.float32)
        want = torch.from_numpy(total / np.float32(4)).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(out["bf16_synced"], want)


def test_mesh_without_pod_returns_errors_unchanged(world):
    for out in world:
        c = out["flat_coords"]
        assert out["flat_errors_same"]
        members = [o for o in world if o["flat_coords"]["model"] == c["model"]]
        assert len(members) == 4
        for k in SHAPES:
            want = sum(_grads(o["coords"]["pod"], o["coords"]["data"], o["coords"]["model"])[k]
                       for o in members) / np.float32(4)
            np.testing.assert_allclose(out["flat_synced"][k], want, rtol=0, atol=1e-6)


def test_mesh_coordinates_are_row_major(world):
    for rank, out in enumerate(world):
        c = out["coords"]
        assert rank == (c["pod"] * 2 + c["data"]) * 2 + c["model"]
        f = out["flat_coords"]
        assert rank == f["data"] * 2 + f["model"]


def test_mesh_needs_a_backend_and_a_matching_world():
    with pytest.raises(ValueError, match="backend"):
        make_test_mesh(data=2, model=1, backend="")
    with pytest.raises(ValueError, match="backend"):
        Mesh((2,), ("data",), backend=None)
    with pytest.raises(ValueError, match="init_method"):
        make_test_mesh(data=2, model=1, backend="gloo", device="cpu")


def test_ranks_that_die_before_taking_their_arguments_let_the_parent_exit():
    """A world whose ranks die before they read their arguments (spawned
    processes cannot find a function of a ``-c`` program) fails ``run_ranks``,
    and the parent then exits: the 4 MiB of arguments left in the queue do
    not hold its exit."""
    code = ("from repro_torch.launch.mesh import run_ranks\n"
            "def lost(*args):\n"
            "    pass\n"
            "try:\n"
            "    run_ranks(lost, 2, b'x' * (4 << 20), init_method='file:///unused', timeout=60)\n"
            "except RuntimeError as e:\n"
            "    print('failed:', str(e).splitlines()[0])\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "failed: ranks [0, 1] exited" in done.stdout


def test_ranks_that_die_apart_are_all_named(tmp_path):
    """Two ranks that exit without a result 1.5 s apart, more than one poll of
    ``run_ranks``: the error names both (``mesh.DEATH_GRACE``)."""
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] exited \(\[3, 3\]\)"):
        run_ranks(die_apart, 2, 1.5, init_method=f"file://{tmp_path}/unused", timeout=60)
