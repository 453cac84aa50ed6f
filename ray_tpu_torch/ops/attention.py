"""Attention: the reference path and flash attention with CUDA kernels.

Counterpart of ``ray_tpu/ops/attention.py``. The three Pallas kernels
there become the CUDA kernels of ``ray_tpu_torch/csrc/flash_attention.cu``:

    K1 flash_fwd       <- _flash_kernel           (forward: o, lse)
    K2 flash_bwd_dq    <- _flash_bwd_dq_kernel    (dQ)
    K3 flash_bwd_dkv   <- _flash_bwd_dkv_kernel   (dK, dV)

Each kernel has a plain PyTorch version of the same function beside it
(``*_plain``). A wrapper takes the plain version only when its tensors lie
on the CPU; a CUDA tensor launches the kernel, and a kernel that cannot be
built or launched raises. Each wrapper counts its launches in
``KERNELS[name].launches``.

Kernel layouts: q [BH, Sq, D], k/v [BH, Sk, D], lse/delta [BH, Sq] fp32.
Public layouts: q, k, v are [batch, num_heads, seq, head_dim]. The kernels
take float32, bfloat16 and float16 at any head dim and any B·H, as JAX's
do (``kernel_route`` says which design runs, at which padded width and in
how many head-dim chunks).

``ring_attention`` splits the sequence over a mesh axis (K/V shards
rotated around the ring by point-to-point ops); its blockwise partials are
plain PyTorch, as JAX computes them with einsums outside any Pallas
kernel, and its backward is an autograd Function of its own.

Contract for fully masked rows (causal, seq_q > seq_k): as in the JAX
``flash_attention``, a row whose q block visits no key block gets 0, and
the backward forces p to 0 wherever the logit is masked. ``mha_reference``
gives mean(V) for such rows instead, as JAX's does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops._build import CudaKernel

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_TILE = 64   # keys per step of K1: kTile and kFwdKeyTile in csrc/


# ---------------------------------------------------------------------------
# Reference implementation (small seqs, correctness baseline)
# ---------------------------------------------------------------------------

def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None):
    """Softmax attention over [B, H, S, D]: logits from a matmul in the
    input dtype, then fp32 softmax, probs cast to ``v.dtype``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        qlen, klen = q.shape[2], k.shape[2]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def _keys_visited(seq_q: int, seq_k: int, causal: bool, block_q: int,
                  block_k: int, device) -> torch.Tensor:
    """[Sq] number of keys the forward visits for each query row: whole
    block_k blocks up to the diagonal of the row's block_q block
    (attention.py:101-106)."""
    if not causal:
        return torch.full((seq_q,), seq_k, dtype=torch.long, device=device)
    qb = torch.arange(seq_q, device=device) // block_q
    nb = torch.div((qb + 1) * block_q + (seq_k - seq_q) + block_k - 1,
                   block_k, rounding_mode="floor")
    return (nb * block_k).clamp(0, seq_k)


def _scores(q, k, causal: bool, sm_scale: float):
    """fp32 logits [BH, Sq, Sk] with masked entries at NEG_INF, and the
    mask of entries a query may attend. Dot inputs keep the input dtype's
    values and accumulate in fp32, as the kernels do."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    if not causal:
        return s, None
    allowed = torch.ones((seq_q, seq_k), dtype=torch.bool,
                         device=q.device).tril(seq_k - seq_q)
    return torch.where(allowed, s, NEG_INF), allowed


def flash_fwd_plain(q, k, v, *, causal: bool, sm_scale: float,
                    block_q: int, block_k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """What K1 computes, in one pass: (o [BH,Sq,D] in q's dtype, lse
    [BH,Sq] fp32). Keys the Pallas forward never visits carry no weight;
    rows that visit nothing get o = 0 and lse = NEG_INF.

    p is rounded to v's dtype where K1 rounds it: against the running max
    of the row after each of K1's KERNEL_TILE-key tiles, the partial sums
    then rescaled to the final max."""
    bh, seq_q, seq_k = q.shape[0], q.shape[1], k.shape[1]
    s, _ = _scores(q, k, causal, sm_scale)
    visited = (torch.arange(seq_k, device=q.device)[None, :]
               < _keys_visited(seq_q, seq_k, causal, block_q, block_k,
                               q.device)[:, None])
    s = torch.where(visited, s, -math.inf)
    n_tiles = -(-seq_k // KERNEL_TILE)
    tiles = torch.nn.functional.pad(
        s, (0, n_tiles * KERNEL_TILE - seq_k), value=-math.inf)
    m_run = (tiles.view(bh, seq_q, n_tiles, KERNEL_TILE).amax(dim=-1)
             .cummax(dim=-1).values.clamp_min(NEG_INF))
    m = m_run[..., -1:]
    m_key = m_run.repeat_interleave(KERNEL_TILE, dim=-1)[..., :seq_k]
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    p = torch.exp(s - m_key).to(v.dtype).float() * torch.exp(m_key - m)
    acc = torch.matmul(p, v.float())
    o = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale):
    """p = exp(s - lse), forced to 0 where masked; dS = p * (dO V^T - δ)."""
    s, allowed = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse[:, :, None])
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[:, :, None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """What K2 computes: dQ = scale * dS K with dS rounded to k's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * sm_scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K3 computes: dV = P^T dO and dK = scale * dS^T Q, with P and
    dS rounded to the input dtype."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                      q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_fwd": CudaKernel(
        "flash_fwd", "flash_attention", "rtt_flash_fwd",
        [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P]),
    "flash_bwd_dq": CudaKernel(
        "flash_bwd_dq", "flash_attention", "rtt_flash_bwd_dq",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
    "flash_bwd_dkv": CudaKernel(
        "flash_bwd_dkv", "flash_attention", "rtt_flash_bwd_dkv",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]),
}


def kernel_route(dtype: torch.dtype, head_dim: int) -> Tuple[str, int, int]:
    """(design, padded head dim, head-dim chunks) of the kernels that take
    ``dtype`` at ``head_dim``, as the library's dispatch decides: ("tensor
    cores", 64/128/192/256, 1) for bf16 and fp16 at 1-256, ("CUDA cores",
    16/32/64/128/256, 1) for fp32, and above 256 the same designs at 192 or
    256 over the fewest chunks of at most 256 columns. Needs the built
    library (the card's toolchain)."""
    fn = _build.load_library("flash_attention").rtt_flash_route
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if not fn(_DTYPES[dtype], int(head_dim), out):
        raise ValueError(f"no flash kernel takes {dtype} at head_dim "
                         f"{head_dim}")
    return ("tensor cores" if out[0] else "CUDA cores"), out[1], out[2]


def _check_inputs(q, k, v, *extra) -> None:
    """Raise on what the kernels do not take."""
    if not (q.dim() == k.dim() == v.dim() == 3):
        raise ValueError("flash kernels take [BH, S, D] tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take float32, bfloat16 or float16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.shape[-1] < 1:
        raise ValueError(f"head_dim {q.shape[-1]}: the flash kernels need "
                         f"at least 1")
    if (k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2] != k.shape[2]):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if min(q.shape[0], q.shape[1], k.shape[1]) <= 0:
        raise ValueError("flash kernels need BH > 0 and seq > 0")
    for t in (q, k, v, *extra):
        if t.device != q.device:
            raise ValueError("flash kernel inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("flash kernel inputs must be contiguous")


def _plain_path(q: torch.Tensor) -> bool:
    """CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on CUDA (or plain on the CPU), "
                         f"not on {q.device}")
    return False


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_bwd(q, do, lse, delta) -> None:
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    for r in (lse, delta):
        if r.dtype != torch.float32 or r.shape != q.shape[:2]:
            raise ValueError("lse/delta must be float32 [BH, Sq]")


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float, block_q: int,
              block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o, lse) for q [BH,Sq,D], k/v [BH,Sk,D]."""
    if _plain_path(q):
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=block_q, block_k=block_k)
    _check_inputs(q, k, v)
    bh, seq_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, seq_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNELS["flash_fwd"](
            _DTYPES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(o),
            _ptr(lse), bh, seq_q, k.shape[1], float(sm_scale), int(causal),
            int(block_q), int(block_k), _stream(q))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """K2: dQ [BH,Sq,D]."""
    if _plain_path(q):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                  sm_scale=sm_scale)
    _check_inputs(q, k, v, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    bh, seq_q, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNELS["flash_bwd_dq"](
            _DTYPES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(lse), _ptr(delta), _ptr(dq), bh, seq_q, k.shape[1],
            float(sm_scale), int(causal), _stream(q))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV) [BH,Sk,D]."""
    if _plain_path(q):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                   sm_scale=sm_scale)
    _check_inputs(q, k, v, do, lse, delta)
    _check_bwd(q, do, lse, delta)
    bh, seq_q, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        KERNELS["flash_bwd_dkv"](
            _DTYPES[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(do),
            _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), bh, seq_q,
            k.shape[1], float(sm_scale), int(causal), _stream(q))
    return dk, dv


# ---------------------------------------------------------------------------
# Flash attention (single device)
# ---------------------------------------------------------------------------

class _FlashFn(torch.autograd.Function):
    """K1 forward, K2 + K3 backward over the saved (q, k, v, out, lse):
    O(seq) memory, no [Sq, Sk] tensor in device memory."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q, block_k):
        b, h, seq_q, d = q.shape
        seq_k = k.shape[2]
        qr = q.reshape(b * h, seq_q, d).contiguous()
        kr = k.reshape(b * h, seq_k, d).contiguous()
        vr = v.reshape(b * h, seq_k, d).contiguous()
        out, lse = flash_fwd(qr, kr, vr, causal=causal, sm_scale=sm_scale,
                             block_q=block_q, block_k=block_k)
        ctx.save_for_backward(qr, kr, vr, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out.view(b, h, seq_q, d)

    @staticmethod
    def backward(ctx, g):
        qr, kr, vr, out, lse = ctx.saved_tensors
        b, h, seq_q, d = g.shape
        seq_k = kr.shape[1]
        gr = g.reshape(b * h, seq_q, d).contiguous()
        # delta_i = rowsum(dO_i * O_i) in fp32, outside the kernels as XLA
        # fuses it outside the Pallas kernels (attention.py:267).
        delta = (gr.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(qr, kr, vr, gr, lse, delta, causal=ctx.causal,
                          sm_scale=ctx.sm_scale)
        dk, dv = flash_bwd_dkv(qr, kr, vr, gr, lse, delta,
                               causal=ctx.causal, sm_scale=ctx.sm_scale)
        return (dq.view(b, h, seq_q, d), dk.view(b, h, seq_k, d),
                dv.view(b, h, seq_k, d), None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128):
    """Fused attention over [B, H, S, D]; O(seq) memory via online softmax.

    ``block_q``/``block_k`` are the JAX kernel's blocks: they decide the
    ragged fallback to ``mha_reference`` and which keys a fully masked row
    averages over. The CUDA kernels pick their own tiles. The tensors'
    device decides between the kernels (CUDA) and their plain versions
    (CPU)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    seq_q, seq_k = q.shape[2], k.shape[2]
    block_q = min(block_q, seq_q)
    block_k = min(block_k, seq_k)
    if seq_q % block_q or seq_k % block_k:
        # Fall back for ragged shapes, as the JAX package does.
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return _FlashFn.apply(q, k, v, causal, float(sm_scale), block_q, block_k)



# ---------------------------------------------------------------------------
# Ring attention (context parallelism over the 'sequence' mesh axis)
# ---------------------------------------------------------------------------

def _blockwise_partials(q, k, v, q_offset: int, k_offset: int, causal: bool,
                        sm_scale: float):
    """Unnormalised attention of q over one K/V block, with its running-max
    statistics: (acc [b,h,q,D], m [b,h,q], l [b,h,q]), all fp32, which
    ``_combine`` merges across blocks. Logits come from a product in the
    input dtype, masked entries are NEG_INF: a fully masked block gives
    m = NEG_INF and p = 1, which ``_combine`` wipes out against any real
    max."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        s = torch.where(_causal_allowed(q, k, q_offset, k_offset), s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return acc, m, l


def _causal_allowed(q, k, q_offset: int, k_offset: int) -> torch.Tensor:
    q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
    return q_pos >= k_pos


def _combine(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def _rotate(tensors, group, index: int, n: int):
    """Each tensor sent to the next rank of the ring and replaced by the
    previous rank's (one batch of point-to-point ops)."""
    nxt = dist.get_global_rank(group, (index + 1) % n)
    prv = dist.get_global_rank(group, (index - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingFn(torch.autograd.Function):
    """The forward of JAX's ring_attention: at step i this rank holds the
    K/V shard of ring position (index - i) mod n, merges its partials into
    the running (acc, m, l) and passes the shard on. The backward visits
    the shards in the same order with p = exp(s - lse), and the dK/dV
    accumulators travel with their shard, which a last rotation returns to
    its owner (JAX transposes ppermute; torch has no such transpose)."""

    @staticmethod
    def forward(ctx, q, k, v, group, index, n, causal, sm_scale):
        b, h, chunk, d = q.shape
        acc = torch.zeros((b, h, chunk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk), dtype=torch.float32, device=q.device)
        kv = (k, v)
        for i in range(n):
            src = (index - i) % n
            a2, m2, l2 = _blockwise_partials(q, *kv, index * chunk,
                                             src * chunk, causal, sm_scale)
            acc, m, l = _combine(acc, m, l, a2, m2, l2)
            if i < n - 1:
                kv = _rotate(kv, group, index, n)
        l = torch.where(l == 0.0, 1.0, l)
        out = (acc / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring = (group, index, n, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, index, n, causal, sm_scale = ctx.ring
        chunk = q.shape[2]
        do = dout.float()
        delta = (do * out.float()).sum(dim=-1)
        q32 = q.float()
        dq = torch.zeros_like(q32)
        kv = (k, v)
        dkv = (torch.zeros_like(q32), torch.zeros_like(q32))
        for i in range(n):
            src = (index - i) % n
            kc, vc = kv
            s = torch.einsum("bhqd,bhkd->bhqk", q, kc).float() * sm_scale
            p = torch.exp(s - lse[..., None])
            if causal:
                p = torch.where(_causal_allowed(q, kc, index * chunk,
                                                src * chunk), p, 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, vc.float())
            ds = p * (dp - delta[..., None]) * sm_scale
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, kc.float())
            dk = dkv[0] + torch.einsum("bhqk,bhqd->bhkd", ds, q32)
            dv = dkv[1] + torch.einsum("bhqk,bhqd->bhkd", p, do)
            if i < n - 1:
                *kv, dk, dv = _rotate((kc, vc, dk, dv), group, index, n)
            dkv = (dk, dv)
        if n > 1:
            dkv = _rotate(dkv, group, index, n)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, *, mesh=None, axis_name: str = "sequence",
                   causal: bool = True, sm_scale: Optional[float] = None):
    """Attention over a sequence split across ``axis_name`` of ``mesh``.

    q, k, v are this rank's shards [B, H, S/n, D] of the sequence, rank i
    holding positions i·S/n onwards; the result is this rank's shard of the
    output. K/V shards go around the ring by point-to-point ops over the
    axis's process group, n - 1 times forward and n times backward. A ring
    of one (``mesh`` None, or an axis of size 1) is one local block. The
    partials are plain PyTorch, as they are einsums outside any Pallas
    kernel in JAX."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    axis = mesh.axis(axis_name) if mesh is not None else None
    n = 1 if axis is None else axis.size
    index = 0 if axis is None else axis.index
    group = None if axis is None else axis.group
    return _RingFn.apply(q, k, v, group, index, n, causal, float(sm_scale))
