"""A run with the timed path broken underneath comes out not correct: once for
each fault a one-card training cell can have (the step's state unchanged;
half of the batch left out, the mean over the rest; a token altered where
the loader produces it), at a size the CPU holds.  The look for a card is
skipped; the rest of the run is the benchmark's."""

import numpy as np
import pytest
import torch

from _tiny import tiny_cell

WORKLOADS = ["phi4-mini-3.8b.train.2x1024", "deepseek-v2-lite-16b.L4.train.4x4096"]


def _run(workload, seed=2**31 + 5):
    from hoardbench import bench

    out = bench.run_cell(tiny_cell(workload), seed, 0.2, False, t_start=0.0, device="cpu")
    return out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    checks = _run(workload)
    assert checks["correct"], checks["numbers"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_state_left_unchanged(workload, monkeypatch):
    from repro_torch.train import step

    def unchanged(grads, state, params, cfg):
        z = torch.zeros(())
        return params, state, {"grad_norm": z, "lr": z}

    monkeypatch.setattr(step, "adamw_update", unchanged)
    checks = _run(workload)
    assert not checks["correct"]
    assert checks["numbers"]["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_left_out(workload, monkeypatch):
    from repro_torch.models.lm import DecoderLM

    loss = DecoderLM.loss

    def half(self, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(DecoderLM, "loss", half)
    checks = _run(workload)
    assert not checks["correct"]
    n = checks["numbers"]
    assert n["grad_diff"][0] > n["grad_diff"][1] and n["data_mismatches"][0] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_token_altered_in_the_loader(workload, monkeypatch):
    from repro_torch.data.tokens import TokenLoader

    read = TokenLoader._read_item

    def altered(self, item):
        row = read(self, item)
        row[5] = (row[5] + 1) % self.spec.vocab
        return row

    monkeypatch.setattr(TokenLoader, "_read_item", altered)
    checks = _run(workload)
    assert not checks["correct"]
    assert checks["numbers"]["data_mismatches"][0] > 0
    assert np.isfinite(checks["numbers"]["loss_gap"][0])
