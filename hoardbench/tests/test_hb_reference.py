"""The plain reference against the port's CPU path at tiny sizes: the loss
and every leaf's gradient of both families on the same weights and batch."""

import pytest
import torch

from _tiny import tiny_cell

WORKLOADS = ["phi4-mini-3.8b.train.2x1024", "deepseek-v2-lite-16b.L4.train.4x4096"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_matches_the_port(workload, seed):
    from hoardbench import bench, weights
    from hoardbench.frozen.corpus import Corpus
    from hoardbench.reference.model import Reference, leaves
    from repro_torch.models import build_model
    from repro_torch.train.step import _grads

    cell = tiny_cell(workload)
    cfg, t = cell["config"], cell["traffic"]
    model = build_model(bench.port_config(cfg), device="cpu")
    params = weights.draw(cfg, seed, torch.device("cpu"), torch.float32)
    _, toks, labels = Corpus(seed, t["n_items"], t["seq_len"], cfg["vocab_size"],
                             t["items_per_chunk"]).batch(0, t["batch"])
    toks, labels = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    loss, _, grads = _grads(model, params, {"tokens": toks, "labels": labels})

    ref_grads = {k: torch.zeros_like(v) for k, v in leaves(params)}
    from hoardbench.reference.model import tree_from
    gtree = tree_from(ref_grads)
    ref_loss, _, _ = Reference(cfg).grads(params, toks, labels, gtree)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    for (name, g), (_, r) in zip(leaves(grads), leaves(gtree)):
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-6 * float(r.abs().max())), name


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_head_by_vocabulary_blocks(workload, monkeypatch):
    """The head's blocks of columns (here 100, not dividing the vocabulary)
    give the loss and gradients of the whole head."""
    from hoardbench import weights
    from hoardbench.frozen.corpus import Corpus
    from hoardbench.reference import model as M

    cell = tiny_cell(workload)
    cfg, t = cell["config"], cell["traffic"]
    params = weights.draw(cfg, 9, torch.device("cpu"), torch.float32)
    _, toks, labels = Corpus(9, t["n_items"], t["seq_len"], cfg["vocab_size"],
                             t["items_per_chunk"]).batch(0, t["batch"])
    toks, labels = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    outs = []
    for cols in (M.HEAD_COLUMNS, 100):
        monkeypatch.setattr(M, "HEAD_COLUMNS", cols)
        gtree = M.tree_from({k: torch.zeros_like(v) for k, v in M.leaves(params)})
        outs.append((M.Reference(cfg).grads(params, toks, labels, gtree)[0], gtree))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=1e-6)
    for (name, a), (_, b) in zip(M.leaves(outs[0][1]), M.leaves(outs[1][1])):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7), name


@pytest.mark.parametrize("factor, plain", [(1, True), (40, False)])
def test_rope_scaling_is_held_to_plain_rope(factor, plain):
    """deepseek's file keeps YaRN's published group at factor 1, which is plain
    RoPE; the reference refuses a factor that would scale it."""
    import copy
    import json

    from _tiny import ROOT
    from hoardbench.reference.model import dims

    cfg = json.loads((ROOT / "hoardbench/configs/deepseek-v2-lite-16b.L4.json").read_text())
    assert cfg["rope_scaling"]["factor"] == 1 and cfg["rope_scaling"]["mscale_all_dim"] == 0.707
    cfg = copy.deepcopy(cfg)
    cfg["rope_scaling"]["factor"] = factor
    if plain:
        assert dims(cfg)["theta"] == 10000.0
    else:
        with pytest.raises(ValueError, match="plain RoPE"):
            dims(cfg)
