"""Parity: ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

On the CPU the port's flash_attention runs the plain PyTorch versions of
its three CUDA kernels (the tensors' device decides), and JAX's runs its
Pallas kernels in interpret mode, as tests/test_parallel.py::TestAttention
runs them. Inputs come from a numpy seed and go to both as numpy arrays.

Tolerances in fp32: 2e-5 on forward values and 2e-4 on grads, the bounds
TestAttention holds the Pallas kernels to against mha_reference. At causal
seq_q > seq_k the first rows see no key; both flash paths give 0 there
(mha_reference gives mean(V)), so those shapes compare the port only
against JAX's flash_attention. In bf16 and fp16
(test_flash_matches_jax_bf16) the bound is the one the card holds each
kernel to against its plain version (chip_smoke.py's RTOL note). The head
dims cover the kernels' compiled widths (16-128) and widths the card pads
(48, 80, 96).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tat

FWD_TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture(scope="module")
def jx(jax_cpu):
    return jax_cpu


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    w = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, w


def _jax_flash(q, k, v, w, causal, bq, bk):
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    def loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_flash(q, k, v, w, causal, bq, bk):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tat.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


# (seq_q, seq_k, head_dim, causal, block_q, block_k)
CASES = [
    (64, 64, 16, True, 32, 32),
    (64, 64, 16, False, 32, 32),
    (128, 128, 32, True, 64, 64),
    (128, 128, 32, False, 64, 64),
    (32, 96, 16, True, 32, 32),     # seq_q < seq_k: bottom-right offset
    (64, 128, 32, False, 32, 64),
    (96, 32, 16, True, 32, 32),     # seq_q > seq_k: 64 rows see no key
    (128, 64, 32, True, 64, 64),
    (64, 32, 16, True, 64, 32),     # masked rows inside a visited block
    # head dims the card's kernels pad (48 to 64, 80 to 128)
    (64, 64, 48, True, 32, 32),
    (64, 128, 80, False, 32, 64),
    (96, 32, 48, True, 32, 32),     # seq_q > seq_k: 64 rows see no key
    (64, 32, 80, True, 64, 32),     # masked rows inside a visited block
]


@pytest.mark.parametrize("sq,sk,d,causal,bq,bk", CASES)
def test_flash_matches_jax(jx, sq, sk, d, causal, bq, bk):
    q, k, v, w = _qkv(sq * 7 + sk + d, 1, 2, sq, sk, d)
    j_out, j_grads = _jax_flash(q, k, v, w, causal, bq, bk)
    t_out, t_grads = _torch_flash(q, k, v, w, causal, bq, bk)
    assert np.abs(t_out - j_out).max() < FWD_TOL
    for name, a, b in zip("qkv", t_grads, j_grads):
        assert np.abs(a - b).max() < GRAD_TOL, name


# bf16 at the main path's head dims, where the card runs the tensor-core
# kernels, and at head dim 96 (padded to 128 there); fp16 at 64 and 80 (the
# card's CUDA-core kernels): (head_dim, causal, dtype) at seq 128, blocks 64.
BF16_CASES = [(64, True, "bfloat16"), (64, False, "bfloat16"),
              (128, True, "bfloat16"), (128, False, "bfloat16"),
              (96, True, "bfloat16"), (64, True, "float16"),
              (80, True, "float16")]
MAX_DIFFERING = 0.03   # share of elements not equal bit for bit


@pytest.mark.parametrize("d,causal,dtype", BF16_CASES, ids=[
    f"{d}-{c}" if t == "bfloat16" else f"{d}-{c}-{t}"
    for d, c, t in BF16_CASES])
def test_flash_matches_jax_bf16(jx, d, causal, dtype):
    """The plain versions, which the card holds the kernels to, round where
    the Pallas kernels round: p to the input type (bf16 or fp16) before P.V
    against the running max of each 64-key block, P and dS to it before
    dS.K, P^T.dO and dS^T.Q.

    Tolerance, element by element: |port - jax| <= rtol (|jax| + |W||X|)
    + E, rtol one ulp of the type (2^-7 bf16, 2^-10 fp16), with W X the
    output's defining product in absolute values (P V, dS K, dS^T Q, P^T
    dO) and E the bound of dP's fp32 summation order for dQ and dK, as
    chip_smoke.check_case holds a kernel to its plain version. The two
    sides round at the same points and differ only in fp32 summation
    order, which can flip one rounding (one ulp) of an output element or
    of a weight of P or dS. One ulp of each element alone does not hold: a
    flipped weight moves an element that is small by cancellation by many
    of its ulps, and in a row that sees one key dS is fp32 rounding noise
    (dP - delta cancels), which E covers.

    That bound alone would pass a plain version that skips a rounding
    point (the error of one skipped rounding is within it), so each output
    must also equal JAX's bit for bit in all but MAX_DIFFERING of its
    elements. Order flips touch about 1% of them here, most in dQ's row 0,
    whose dS is noise; a skipped rounding of P or dS touches a quarter or
    more.
    """
    import chip_smoke
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v, w = (jnp.asarray(x, dtype=jdt)
                  for x in _qkv(d + int(causal), 1, 2, 128, 128, d))

    def loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal, block_q=64,
                              block_k=64, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w.astype(jnp.float32)), out

    (_, j_out), j_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)

    def flat(x):   # bf16 or fp16 through fp32 numpy arrays: exact
        t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
        return t.to(tdt).reshape(2, 128, d)

    tq, tk, tv, tw = (flat(x) for x in (q, k, v, w))
    leaves = [t.view(1, 2, 128, d).clone().requires_grad_(True)
              for t in (tq, tk, tv)]
    t_out = tat.flash_attention(*leaves, causal=causal, block_q=64,
                                block_k=64)
    (t_out.float() * tw.view(1, 2, 128, d).float()).sum().backward()
    assert t_out.dtype == tdt

    scale = 1.0 / np.sqrt(d)
    o, lse = tat.flash_fwd_plain(tq, tk, tv, causal=causal, sm_scale=scale,
                                 block_q=64, block_k=64)
    delta = (tw.float() * o.float()).sum(-1)
    mag = chip_smoke._magnitudes(tq, tk, tv, tw, lse, delta, causal, scale,
                                 64, 64)
    rtol = chip_smoke.RTOL[tdt]
    got = [t_out] + [t.grad for t in leaves]
    want = [j_out] + list(j_grads)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        a, b = a.detach().reshape(2, 128, d), flat(b)
        ratio = chip_smoke._bound_ratio(a, b, mag[name], rtol,
                                        mag.get(name + "_sum", 0.0))
        assert ratio <= 1.0, (name, ratio)
        differ = float((a != b).float().mean())
        assert differ <= MAX_DIFFERING, (name, differ)


def test_fully_masked_rows_are_zero(jx):
    """The flash contract: rows whose q block visits no key block are 0 in
    both packages, and their grads are 0."""
    q, k, v, w = _qkv(3, 1, 2, 96, 32, 16)
    t_out, t_grads = _torch_flash(q, k, v, w, True, 32, 32)
    j_out, _ = _jax_flash(q, k, v, w, True, 32, 32)
    assert np.all(t_out[:, :, :64] == 0.0)
    assert np.all(j_out[:, :, :64] == 0.0)
    assert np.all(t_grads[0][:, :, :64] == 0.0)


def test_ragged_falls_back_to_reference(jx):
    """seq not divisible by the block: both packages fall back to
    mha_reference (a different result from the flash path's)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.attention import flash_attention

    q, k, v, w = _qkv(11, 1, 2, 48, 48, 16)
    t_out, t_grads = _torch_flash(q, k, v, w, True, 32, 32)
    j_out = np.asarray(flash_attention(q, k, v, causal=True, block_q=32,
                                       block_k=32))
    j_grads = jax.grad(
        lambda q, k, v: jnp.sum(flash_attention(
            q, k, v, causal=True, block_q=32, block_k=32) * w),
        argnums=(0, 1, 2))(q, k, v)
    ref = tat.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    assert np.abs(t_out - ref.numpy()).max() == 0.0
    assert np.abs(t_out - j_out).max() < FWD_TOL
    for a, b in zip(t_grads, j_grads):
        assert np.abs(a - np.asarray(b)).max() < GRAD_TOL


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, True), (64, 64, False),
                                          (32, 96, True), (96, 32, True)])
def test_mha_reference_matches_jax(jx, sq, sk, causal):
    from ray_tpu.ops.attention import mha_reference
    q, k, v, _ = _qkv(5, 2, 2, sq, sk, 32)
    j = np.asarray(mha_reference(q, k, v, causal=causal))
    t = tat.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal).numpy()
    assert np.abs(t - j).max() < FWD_TOL


def test_plain_versions_agree_with_autograd_of_reference():
    """The plain dQ/dK/dV equal autograd through mha_reference where no row
    is fully masked (fp32, 2e-4 as above)."""
    q, k, v, w = _qkv(7, 1, 2, 64, 96, 32)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tat.mha_reference(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    _, grads = _torch_flash(q, k, v, w, True, 32, 32)
    for a, b in zip(grads, (tq.grad, tk.grad, tv.grad)):
        assert np.abs(a - b.numpy()).max() < GRAD_TOL


def test_plain_forward_tiles_keys_as_the_kernels_do():
    """flash_fwd_plain rounds p against the running max after every
    KERNEL_TILE keys; both forward kernels (the CUDA-core kTile and the
    tensor-core kFwdKeyTile) must step over keys by that many."""
    csrc = Path(tat.__file__).resolve().parent.parent / "csrc"
    found = {}
    for path in sorted(csrc.glob("*.cu*")):
        for name, value in re.findall(
                r"constexpr int (kTile|kFwdKeyTile) = (\d+);",
                path.read_text()):
            found[name] = int(value)
    assert found == {"kTile": tat.KERNEL_TILE,
                     "kFwdKeyTile": tat.KERNEL_TILE}
