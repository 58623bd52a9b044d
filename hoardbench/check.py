"""The comparison that decides ``correct``.

Four numbers, each against its limit in ``limits/<workload>.json``:

* ``data_mismatches``: the batches, of every step the run made, whose item
  ids or token bytes (CRC-32) differ from those the frozen corpus gives for
  that step (``frozen.corpus``); exact, limit 0;
* ``loss_gap``: the largest relative gap between the program's loss and the
  reference's over the checked steps;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (the program's, read from its first
  moment after one step: ``mu / (1 - b1)``; the reference's, after the clip),
  against the reference's norm of that leaf or of the median leaf, whichever
  is larger;
* ``change_gap``: the same of the norms of each leaf's change over the
  checked steps (the program's fp32 master, as the next step takes it),
  over the leaves whose first gradient in the reference is at least
  :data:`MOVED` of the median leaf's (a leaf below it moves by round-off).

* ``grad_diff``, where the cell's limits name it: the worst leaf's norm of
  the difference of the two first gradients (the program's kept on the host
  after its first step), over the same norm as ``grad_gap``.

A gap whose limit is ``null`` has no upper reading at that cell (neither the
control nor a planted fault reads far enough out): it is printed and not
compared.

The reference (``reference/``) is given the seed's weights (``weights.py``)
in float32 and the frozen corpus's batches, and follows the checked steps
once the program's state is freed.
"""

from __future__ import annotations

import math
import statistics
import sys
import zlib
from types import SimpleNamespace

import torch

from . import weights
from .frozen.corpus import Corpus
from .reference.model import layout, leaves, tree_from
from .reference.train import follow

#: a leaf counts for ``change_gap`` where its first reference gradient is at
#: least this share of the median leaf's
MOVED = 1e-3
SLICE = 1 << 26


class ProgramReadings(SimpleNamespace):
    """What the run reads of the program: ``losses`` of the checked steps,
    ``grad`` and ``change`` leaf norms by dotted name."""


def diff_norm(a: torch.Tensor, b: torch.Tensor = None) -> float:
    """``||a - b||`` (or ``||a||``) in float64, over slices of the flat leaves."""
    fa = a.reshape(-1)
    fb = None if b is None else b.reshape(-1)
    total = 0.0
    for i in range(0, fa.numel(), SLICE):
        x = fa[i:i + SLICE].double()
        if fb is not None:
            x = x - fb[i:i + SLICE].double()
        total += float(x.square().sum())
    return math.sqrt(total)


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """``|prog - ref| / max(ref, median ref)`` of each leaf of ``names``."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def data_mismatches(corpus: Corpus, batch: int, log) -> int:
    """The steps whose item ids or token bytes differ from the frozen corpus's."""
    bad = 0
    for s, (ids, crc) in enumerate(zip(log.ids, log.crc)):
        ref_ids, toks, _ = corpus.batch(s, batch)
        bad += int(list(map(int, ref_ids)) != list(ids) or zlib.crc32(toks.tobytes()) != crc)
    return bad


def reference_readings(cfg: dict, traffic: dict, seed: int, dev, precision: str = "fp32",
                       rows=None, keep_grads: bool = False, compare_to: dict = None) -> dict:
    """The reference's losses, first-gradient and change leaf norms over the
    checked steps; ``rows`` keeps only those rows of each batch (a planted
    fault of the control script)."""
    served = getattr(torch, cfg["assumed"]["dtype"])
    specs = dict(leaves(layout(cfg)))
    params = tree_from({n: weights.draw_leaf(s, seed, n, dev, served).float()
                        for n, s in specs.items()})
    corpus = Corpus(seed, traffic["n_items"], traffic["seq_len"], cfg["vocab_size"],
                    traffic["items_per_chunk"])
    batches = []
    for s in range(traffic["checked_steps"]):
        _, toks, labels = corpus.batch(s, traffic["batch"])
        if rows is not None:
            toks, labels = toks[rows], labels[rows]
        batches.append((torch.from_numpy(toks).long().to(dev),
                        torch.from_numpy(labels).long().to(dev)))
    out = follow(cfg, params, batches, traffic["optimizer"], precision, keep_grads, compare_to)
    out["change"] = {}
    for n, t in leaves(params):
        init = weights.draw_leaf(specs[n], seed, n, dev, served)
        out["change"][n] = diff_norm(t, init.float())
        del init
    del params
    return out


def gaps(prog, ref: dict, diff_norms: dict = None) -> dict:
    """The gaps of the program's readings against the reference's, with the
    leaf that sets each; with ``diff_norms`` (the norms of each leaf's
    difference of the two first gradients) also ``grad_diff``."""
    med_raw = statistics.median(ref["grad_raw"].values())
    moved = [n for n, v in ref["grad_raw"].items() if v >= MOVED * med_raw]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog.losses, ref["losses"]))
    grad = leaf_gaps(prog.grad, ref["grad"], list(ref["grad"]))
    change = leaf_gaps(prog.change, ref["change"], moved)
    grad_leaf, change_leaf = max(grad, key=grad.get), max(change, key=change.get)
    out = {"loss_gap": loss, "grad_gap": grad[grad_leaf], "change_gap": change[change_leaf],
           "grad_leaf": grad_leaf, "change_leaf": change_leaf, "grad_leaves": grad,
           "change_leaves": change, "unmoved": sorted(set(ref["grad_raw"]) - set(moved))}
    if diff_norms is not None:
        diffs = leaf_gaps({n: diff_norms[n] + ref["grad"][n] for n in diff_norms}, ref["grad"],
                          list(diff_norms))
        out["grad_diff_leaf"] = max(diffs, key=diffs.get)
        out["grad_diff"] = diffs[out["grad_diff_leaf"]]
        out["grad_diff_leaves"] = diffs
    return out


def compare(cell: dict, seed: int, dev, prog, log, keep_grads: bool = False) -> dict:
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    corpus = Corpus(seed, traffic["n_items"], traffic["seq_len"], cfg["vocab_size"],
                    traffic["items_per_chunk"])
    mism = data_mismatches(corpus, traffic["batch"], log)
    nonfinite = sum(not math.isfinite(x) for x in log.losses)
    ref = reference_readings(cfg, traffic, seed, dev, keep_grads=keep_grads,
                             compare_to=getattr(prog, "grad_tensors", None))
    g = gaps(prog, ref, ref.get("grad_diff_norms"))
    print(f"[check] program losses {prog.losses} reference {ref['losses']}; worst grad leaf "
          f"{g['grad_leaf']}, worst change leaf {g['change_leaf']}; leaves left out of the "
          f"change {g['unmoved']}", file=sys.stderr)
    numbers = {"data_mismatches": [mism, limits["data_mismatches"]],
               "nonfinite_losses": [nonfinite, 0]}
    for k in ("loss_gap", "grad_gap", "change_gap", "grad_diff"):
        if k not in g:
            continue
        if limits.get(k) is None:            # no upper reading at this cell: not compared
            print(f"[check] {k} {g[k]!r} (not compared at this cell)", file=sys.stderr)
        else:
            numbers[k] = [g[k], limits[k]]
    correct = all(v <= lim for v, lim in numbers.values())
    return {"correct": correct, "numbers": numbers, "failed_steps": mism + nonfinite,
            "ref": ref, "gaps": g}
