"""The frozen yardstick: parameter counts, model FLOPs a token and the
attention kernels' least times, against figures worked out by hand."""

import json
from pathlib import Path

import pytest

from archs.gpt.spec import ModelSpec
from harness.spec import attn_bound_s

HERE = Path(__file__).resolve().parent

# allenai/OLMo-7B-hf config.json's widths (the port's GPT family).
OLMO_7B = dict(vocab_size=50304, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32, rope_theta=10000.0)


def stablelm():
    return ModelSpec.from_config(json.loads(
        (HERE / "configs" / "stablelm-3b-4e1t.json").read_text()))


def test_parameter_counts():
    s, o = stablelm(), ModelSpec.from_config(OLMO_7B)
    assert s.n_params() == 2_795_276_800
    assert o.n_params() == 6_888_361_984
    # In weight products: every matrix but the embedding's lookup.
    assert s.n_matmul_params() == 2_666_332_160
    assert o.n_matmul_params() == 6_682_050_560
    assert s.head_dim == 80 and o.head_dim == 128


@pytest.mark.parametrize("which, seq, gflop", [
    ("stablelm", 4096, 18.01), ("stablelm", 1024, 16.50),
    ("olmo", 2048, 41.70)])
def test_model_flops_per_token(which, seq, gflop):
    spec = stablelm() if which == "stablelm" else ModelSpec.from_config(
        OLMO_7B)
    assert spec.model_flops_per_token(seq) / 1e9 == pytest.approx(
        gflop, abs=0.005)


@pytest.mark.parametrize("kernel, ms, by", [
    ("flash_fwd", 0.0151, "bytes"), ("flash_bwd_dq", 0.0196, "operations"),
    ("flash_bwd_dkv", 0.0261, "operations")])
def test_attention_bounds_at_the_main_shape(kernel, ms, by):
    """B·H 96, S 1024, D 64, bf16, causal: the bounds the kernel table has
    carried since the kernels were ported."""
    s, what = attn_bound_s(kernel, 96, 1024, 64, "bfloat16")
    assert 1e3 * s == pytest.approx(ms, abs=5e-5)
    assert what == by


def test_weights_are_drawn_again_alike():
    import torch
    from harness.weights import block_weights, token_pool
    spec = ModelSpec.from_config(dict(OLMO_7B, hidden_size=64,
                                      intermediate_size=96,
                                      num_hidden_layers=2,
                                      num_attention_heads=4,
                                      vocab_size=128))
    seed = 2 ** 31 + 77
    for b in range(len(spec.blocks())):
        one = block_weights(spec, seed, b, "cpu")
        two = block_weights(spec, seed, b, "cpu")
        assert one.keys() == two.keys()
        assert all(torch.equal(one[k], two[k]) for k in one)
    other = block_weights(spec, seed + 1, 1, "cpu")
    assert not torch.equal(other["layers.0.attn.wq"],
                           block_weights(spec, seed, 1,
                                         "cpu")["layers.0.attn.wq"])
    pool = token_pool(seed, 4, 2, 16, 128)
    assert pool.shape == (4, 2, 17) and pool.max() < 128
    assert (pool == token_pool(seed, 4, 2, 16, 128)).all()
