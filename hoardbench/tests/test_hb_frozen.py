"""The frozen copies against the program's originals as they stand."""

import numpy as np
import pytest


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_corpus_is_the_programs(seed):
    from hoardbench.frozen.corpus import Corpus, chunk_payload
    from repro_torch.data import tokens as T

    spec = T.TokenDatasetSpec("c", n_sequences=40, seq_len=12, vocab=300, seed=seed)
    for c in range(3):
        assert np.array_equal(chunk_payload(seed, c, 8, 12, 300), T.chunk_payload(spec, c, 8))
    corpus = Corpus(seed, 40, 12, 300, 8)
    loader = T.TokenLoader(None, spec, None, batch=3)
    loader._read_item = lambda i: np.frombuffer(T.read_item(spec, int(i), items_per_chunk=8),
                                                np.int32)
    it = iter(loader)
    for step in range(30):                          # across the epoch's end (13 a epoch)
        toks, labels = next(it)
        ids, rtoks, rlabels = corpus.batch(step, 3)
        assert list(ids) == list(loader.last_ids)
        assert np.array_equal(toks, rtoks) and np.array_equal(labels, rlabels)


def test_cost_formulas_are_the_programs():
    from hoardbench.frozen import cost as F
    from repro_torch.kernels import cost as P

    for args in [(2, 24, 1024, 1024, 128), (4, 16, 4096, 4096, 192), (1, 8, 300, 300, 64)]:
        for hdv in (None, 128):
            assert F.flash_attention_flops(*args, head_dim_v=hdv) == \
                P.flash_attention_cost(*args, head_dim_v=hdv).flops
    assert F.avg_context(100, 100, window=16) == P.avg_context(100, 100, window=16)
    for n, d, f in [(2048, 3072, 8192), (16384, 2048, 2816)]:
        c = P.swiglu_cost(n, d, f)
        assert F.swiglu_cost(n, d, f) == (c.flops, c.bytes_accessed)
        for fr, pr in ((F.rmsnorm_cost, P.rmsnorm_cost), (F.rmsnorm_bwd_cost, P.rmsnorm_bwd_cost)):
            c = pr(n, d)
            assert fr(n, d) == (c.flops, c.bytes_accessed)
    fwd = P.flash_attention_cost(2, 4, 64, 64, 32)
    assert P.flash_attention_bwd_cost(2, 4, 64, 64, 32).flops == F.BACKWARD_FACTOR * fwd.flops


def test_grouping_is_the_programs():
    from hoardbench.frozen import groups
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.launch import trace as T

    own = groups.port_kernels(build.CSRC)
    assert own == T.KERNEL_SOURCE
    names = [f"void (anonymous namespace)::{k}<128>(float*)" for k in sorted(own)] + [
        "(anonymous namespace)::split::decode_split_kernel(float*)", "nvjet_tst_128x256",
        "sm90_xmma_gemm_bf16", "void at::native::vectorized_elementwise_kernel<4>",
        "cutlass::Kernel2<x>", "ampere_bf16_s16816gemm"]
    for n in names:
        assert groups.kernel_group(n, own) == T.kernel_group(n)
    moe = ARCHS["deepseek-v2-lite-16b"].moe
    for shapes in ([[64, 1920, 2048], [64, 2048, 1408]], [[64, 1920, 1408], [64, 1408, 2048]],
                   [[16, 4096, 192], [16, 192, 4096]], [[64, 10, 10], [64, 10, 10]], [[3, 4]]):
        assert groups.is_routed_expert_bmm(shapes, moe.n_experts, moe.d_expert, 2048) == \
            T.is_routed_expert_bmm(shapes, moe, 2048)
