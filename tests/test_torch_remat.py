"""Rematerialisation (``cfg.remat``: none, dots, full) in every family of the port.

The smoke configs of qwen1.5-0.5b (dense), deepseek-v2-lite-16b (MoE and MLA,
with ``layer0``), hymba-1.5b (4 layers: a run of 2 sliding-window blocks),
xlstm-1.3b (3 mLSTM and 1 sLSTM block), internvl2-2b (an image prefix) and
whisper-large-v3 (encoder and decoder), on the CPU:

* the port's loss and every gradient are equal bit for bit across the three
  policies (a recompute runs the same ops on the same inputs);
* at each policy they match JAX's ``jax.checkpoint`` at the same
  ``cfg.remat`` on the same numpy-seeded weights, the loss within 1e-5 and
  each gradient leaf within 1e-4 of its largest entry;
* on the meta device under the step counter: every forward kernel of the
  blocks runs twice under ``dots`` and ``full`` (the forward and the
  recompute), the backward kernels once; ``dots`` counts the matmul FLOPs of
  ``none`` plus the forward's batched products (the routed experts', the
  sLSTM's), ``full`` those of ``none`` plus one forward of the blocks'
  products but each block's closing one; the live-bytes peak orders ``full < dots < none`` at a size
  where the activations dominate;
* the SwiGLU forward kernel runs again in the recompute under ``dots``
  (a deliberate difference from JAX's policy, which keeps its products).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro_torch.configs import ARCHS
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.models import remat as port_remat
from repro_torch.roofline import count as C

FAMILIES = ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-1.3b", "internvl2-2b",
            "whisper-large-v3")
POLICIES = ("none", "dots", "full")
#: frames of Whisper's smoke batch
FRAMES = 40
#: (B, S) at which the activations dominate the step's peak above its state; the
#: xLSTM's sLSTM loop is counted op by op on meta, so it keeps the smoke batch
PEAK_BATCH = {arch: (4, 256) for arch in FAMILIES} | {"xlstm-1.3b": (2, 64)}
#: the forward kernels whose backward is a kernel of its own (``name`` + "_bwd")
FORWARD_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "mlstm_scan", "ssd_scan")


def _cfg(registry, arch, policy):
    cfg = registry[arch].smoke()
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, n_layers=4, hybrid=dataclasses.replace(
            cfg.hybrid, global_layers=(0, 3)))
    return dataclasses.replace(cfg, remat=policy)


def _arrays(cfg, B=2, S=64, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.vlm is not None:
        out["img_emb"] = rng.normal(size=(B, cfg.vlm.n_image_tokens, cfg.d_model))
    if cfg.encdec is not None:
        out["enc_emb"] = rng.normal(size=(B, FRAMES, cfg.d_model))
    return {k: a.astype(np.float32) if a.dtype == np.float64 else a for k, a in out.items()}


def _port_batch(arrays: dict) -> dict:
    return {k: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
            for k, a in arrays.items()}


def _meta_batch(cfg, B, S) -> dict:
    return {k: torch.empty(a.shape, dtype=t.dtype, device="meta")
            for (k, a), t in zip(_arrays(cfg, B, S).items(),
                                 _port_batch(_arrays(cfg, 1, 1)).values())}


@pytest.fixture(scope="module")
def jax_params():
    """arch -> JAX's fp32 smoke weights (the same for every policy: ``remat``
    changes no layout)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jmodel = jbuild_model(_cfg(JARCHS, arch, "none"), mesh=None)
            cache[arch] = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), "float32")
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def port_results(jax_params):
    """(arch, policy) -> the port's (loss, gradient leaves) on JAX's weights."""
    cache = {}

    def get(arch, policy):
        if (arch, policy) not in cache:
            cfg = _cfg(ARCHS, arch, policy)
            model = build_model(cfg, device="cpu")
            params = PM.params_from_jax(jax.tree.map(np.asarray, jax_params(arch)),
                                        device="cpu", dtype=None)
            leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, _ = model.loss(leaves, _port_batch(_arrays(cfg)))
            grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
            cache[(arch, policy)] = (loss.detach(), grads)
        return cache[(arch, policy)]
    return get


def _meta_counts(arch, policy, B=2, S=64, backward=True) -> dict:
    """The step counter's result of ``loss`` and its gradients on meta, with
    no weights (or of the forward alone, still under autograd: PyTorch's
    ``matmul`` folds a strided input into one ``mm`` only when a gradient
    is wanted)."""
    cfg = _cfg(ARCHS, arch, policy)
    model = build_model(cfg, device="meta")

    def step(params, batch):
        leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss(leaves, batch)
        return torch.autograd.grad(loss, PM.tree_leaves(leaves)) if backward else loss

    return C.count(step, PM.abstract(model.layout(), cfg.dtype), _meta_batch(cfg, B, S))[1]


class _BmmFlops(TorchDispatchMode):
    """The FLOPs of the batched products (``aten.bmm``) dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket is torch.ops.aten.bmm:
            self.flops += flop_registry[torch.ops.aten.bmm](*args, out_val=out)
        return out


def _unembed_flops(cfg, B, S) -> int:
    """The unembedding's product, outside every block: the text positions."""
    return 2 * B * S * cfg.d_model * cfg.vocab


def _closing_flops(cfg, B, S) -> int:
    """The products that close a block and that ``full`` does not run again:
    autograd saves a product's inputs before it runs, so the recompute stops
    (PyTorch's early stop) before a block's last plain product, whose output
    the backward does not need (XLA drops it too).  The mLSTM block ends in
    ``w_down``, Whisper's layers in the MLP's ``w_out``; the other blocks end
    in a kernel or in ops whose saved tensors come later."""
    D = cfg.d_model
    if cfg.family == "ssm":
        model = build_model(cfg, device="meta")
        mlstm_blocks = cfg.n_layers - cfg.n_layers // cfg.ssm.slstm_every
        return mlstm_blocks * 2 * B * S * model.ed * D
    if cfg.encdec is not None:
        return 2 * cfg.d_ff * D * (cfg.encdec.n_encoder_layers * B * FRAMES + cfg.n_layers * B * S)
    return 0


# -------------------------------------------------------------- values
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_equal_across_policies(arch, port_results):
    loss, grads = port_results(arch, "none")
    for policy in ("dots", "full"):
        other_loss, other_grads = port_results(arch, policy)
        assert torch.equal(other_loss, loss), policy
        assert len(other_grads) == len(grads)
        for a, b in zip(other_grads, grads):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax_at_same_remat(arch, policy, jax_params, port_results):
    jcfg = _cfg(JARCHS, arch, policy)
    assert jcfg.remat == policy
    jmodel = jbuild_model(jcfg, mesh=None)
    jbatch = {k: jnp.asarray(a) for k, a in _arrays(jcfg).items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jax_params(arch), jbatch)
    loss, grads = port_results(arch, policy)
    assert abs(float(loss) - float(jloss)) < 1e-5
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


# -------------------------------------------------------------- counts
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counts_the_recompute(arch):
    counts = {p: _meta_counts(arch, p) for p in POLICIES}
    calls = {p: {k: v["calls"] for k, v in c["kernels"].items()} for p, c in counts.items()}
    none = calls["none"]
    assert none and set(calls["dots"]) == set(none) == set(calls["full"])
    for name in FORWARD_KERNELS:
        if name not in none:
            continue
        # the final norm lies outside every block: it runs once
        outside = 1 if name == "rmsnorm" and arch != "whisper-large-v3" else 0
        for policy in ("dots", "full"):
            assert calls[policy][name] == 2 * none[name] - outside, (policy, name)
            assert calls[policy][f"{name}_bwd"] == none[f"{name}_bwd"] == none[name]

    with _BmmFlops() as bmm:
        fwd = _meta_counts(arch, "none", backward=False)
    mm = {p: c["matmul_flops"] for p, c in counts.items()}
    # dots keeps the products with no batch dimension and recomputes the batched ones
    assert mm["dots"] - mm["none"] == bmm.flops
    assert (bmm.flops > 0) == (arch in ("deepseek-v2-lite-16b", "xlstm-1.3b"))
    # full recomputes one forward of every block's products but the closing ones
    cfg = _cfg(ARCHS, arch, "none")
    assert mm["full"] - mm["none"] == (fwd["matmul_flops"] - _unembed_flops(cfg, 2, 64)
                                       - _closing_flops(cfg, 2, 64))


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_peak_orders_full_dots_none(arch):
    B, S = PEAK_BATCH[arch]
    peak = {p: _meta_counts(arch, p, B, S)["peak_above_start_bytes"] for p in POLICIES}
    assert peak["full"] < peak["dots"] < peak["none"], peak


def test_swiglu_forward_runs_again_under_dots(monkeypatch):
    """A deliberate difference from JAX: its ``dots`` keeps ``x @ Wg``, ``x @ Wu``
    and the down product of the SwiGLU MLP; the port's SwiGLU forward is one
    kernel that the policy cannot see, so it runs again in the recompute.  The
    backward still takes a and b from that run and runs once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.swiglu_fwd_ref, ref.swiglu_bwd_saved_ref

    def counted_fwd(*args):
        calls["fwd"] += 1
        return fwd(*args)

    def counted_bwd(*args):
        calls["bwd"] += 1
        return bwd(*args)

    monkeypatch.setattr(ref, "swiglu_fwd_ref", counted_fwd)
    monkeypatch.setattr(ref, "swiglu_bwd_saved_ref", counted_bwd)
    layers = ARCHS["qwen1.5-0.5b"].smoke().n_layers
    for policy, want in (("none", layers), ("dots", 2 * layers), ("full", 2 * layers)):
        calls.update(fwd=0, bwd=0)
        cfg = _cfg(ARCHS, "qwen1.5-0.5b", policy)
        model = build_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss(leaves, _port_batch(_arrays(cfg)))
        torch.autograd.grad(loss, PM.tree_leaves(leaves))
        assert calls == {"fwd": want, "bwd": layers}, policy


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_grad_paths_take_no_checkpoint(arch, monkeypatch):
    """``prefill`` (and so the engines) runs under ``torch.no_grad``: the
    blocks run directly, with no checkpoint, and give ``none``'s logits."""
    def refuse(*args, **kwargs):
        raise AssertionError("a checkpoint under torch.no_grad")

    logits = {}
    for policy in ("none", "dots"):
        cfg = _cfg(ARCHS, arch, policy)
        model = build_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        batch = _port_batch(_arrays(cfg))
        batch.pop("labels")
        with monkeypatch.context() as m:
            m.setattr(port_remat, "checkpoint", refuse)
            logits[policy] = model.prefill(params, batch)
    assert torch.equal(logits["dots"], logits["none"])
