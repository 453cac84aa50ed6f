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
