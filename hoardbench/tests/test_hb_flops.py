"""``flops.py`` against a count by hand at both configurations."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "hoardbench" / "configs" / f"{name}.json").read_text())


def test_phi4_mini_by_hand():
    from hoardbench import flops

    D, H, Hkv, hd, F, V, L, S = 3072, 24, 8, 128, 8192, 200064, 32, 1024
    per_layer = D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F
    params = L * per_layer + D * V
    assert params == 3_835_822_080
    attn = 3 * L * H * 2 * (S + 1) / 2 * (hd + hd)
    assert flops.flops_per_token(_cfg("phi4-mini-3.8b"), S) == pytest.approx(6 * params + attn,
                                                                            rel=1e-12)
    assert 6 * params + attn == pytest.approx(2.36195e10, rel=1e-5)


def test_deepseek_v2_lite_four_layers_by_hand():
    from hoardbench import flops

    D, H, r, dn, dr, dv, V, S = 2048, 16, 512, 128, 64, 128, 102400, 4096
    E, k, Fe, shared, F0 = 64, 6, 1408, 2, 10944
    attn = D * H * (dn + dr) + D * (r + dr) + r * H * dn + r * H * dv + H * dv * D
    moe = 3 * D * Fe * (k + shared) + D * E
    params = 4 * attn + 3 * D * F0 + 3 * moe + D * V
    assert params == 540_016_640
    att = 3 * 4 * H * 2 * (S + 1) / 2 * (dn + dr + dv)
    got = flops.flops_per_token(_cfg("deepseek-v2-lite-16b.L4"), S)
    assert got == pytest.approx(6 * params + att, rel=1e-12)
    assert got == pytest.approx(3.49182e9, rel=1e-5)
