"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no card is present (they need nvcc and a
GPU). On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances are chip_smoke.py's (its ``check_case``): element by element,
|kernel - plain| <= rtol (|plain| + |W||X|), with W X the product that
defines the output, rtol 1e-5 in fp32 and 2^-7 (one bf16 ulp) in bf16;
lse within 1e-4 absolute.
"""

import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops import attention as A


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on the card only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,dtype,causal,bq,bk", [
    (128, 128, 64, torch.bfloat16, True, 128, 128),
    (96, 32, 32, torch.float32, True, 32, 32),
    (64, 192, 16, torch.float32, False, 32, 64),
    (160, 96, 128, torch.bfloat16, True, 32, 32),
    # bf16 at head dims 64 and 128 runs K1 and K3 on the tensor cores.
    (64, 32, 64, torch.bfloat16, True, 64, 32),      # masked rows: mean V
    (96, 224, 128, torch.bfloat16, False, 32, 32),
    (96, 32, 64, torch.bfloat16, True, 32, 32),      # rows with no keys
    (1024, 1024, 128, torch.bfloat16, True, 128, 128),
])
def test_kernels_match_plain(card, sq, sk, d, dtype, causal, bq, bk):
    res = chip_smoke.check_case(3, sq, sk, d, dtype, causal, bq, bk, card)
    assert all(ok for _, _, ok, _ in res.values()), res


@pytest.mark.cuda
def test_cuda_tensor_launches_kernel(card):
    before = A.KERNELS["flash_fwd"].launches
    q = torch.randn((1, 2, 64, 32), generator=card, device="cuda")
    A.flash_attention(q, q, q, block_q=64, block_k=64)
    assert A.KERNELS["flash_fwd"].launches == before + 1


@pytest.mark.cuda
def test_unsupported_input_raises(card):
    q = torch.randn((2, 64, 48), generator=card, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_fwd(q, q, q, causal=True, sm_scale=1.0, block_q=64,
                    block_k=64)


def _one_card_run(cfg, weights, toks, steps):
    """The whole batch on one card through mesh=None: per step (loss,
    grad_norm, {name: AdamW's gradient}), the final params, eval loss."""
    from torch_dp_worker import _RecordingAdamW

    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.train import make_eval_step
    from ray_tpu_torch.train import train_step as tts
    model = tgpt.gpt_init(cfg, device="cuda")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    opt = _RecordingAdamW(3e-4)
    state = tts.init_train_state(lambda: model, opt)
    step = tts.make_train_step(tgpt.gpt_loss, opt)
    batch = {"tokens": torch.from_numpy(toks).long().cuda()}
    names = [n for n, _ in model.named_parameters()]
    out = []
    for i in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {n: g.cpu().numpy() for n, g in zip(names, opt.seen[i])}))
    final = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    ev = float(make_eval_step(tgpt.gpt_loss)(model, batch))
    return out, final, ev


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_dp_across_cards_matches_one_card(card, tmp_path):
    """The dp step with one NCCL rank per card of the host, against the
    whole batch on one card: GPTConfig.tiny() in fp32 (the CUDA-core
    kernels) with MoE, unequal masks (targets -1 in the last rank's rows
    only), 3 AdamW steps, tests/test_torch_dp.py's bounds; the ranks'
    params bit-identical. Needs two cards or more."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards")
    import dataclasses

    import numpy as np
    import test_torch_dp as D

    from ray_tpu_torch.models import gpt as tgpt
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), dtype=torch.float32,
                              n_experts=4)
    init = tgpt.gpt_init(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    weights = {n: p.detach().numpy().copy()
               for n, p in init.state_dict().items()}
    rows = 2 * world
    toks = np.random.default_rng(3).integers(0, 512, (rows, 33)).astype(
        np.int32)
    toks[rows - 2:, 12:] = -1
    ranks = D._run_ranks(tmp_path, weights, toks, 4, "full", 0,
                         device="cuda", world=world)
    D.assert_ranks_match(ranks, *_one_card_run(cfg, weights, toks, D.STEPS))
