"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  (a) the device, and nvidia-smi's name and power limit for it;
  (b) build the CUDA kernels from ray_tpu_torch/csrc with nvcc;
  (c) hold each kernel against its plain PyTorch version on the card, at
      the main-path shape (B·H 96, also the MoE phase's), the GPT-2-medium
      shape (B·H 128) and at small shapes (head_dim 16-128, causal on and
      off, seq_q < seq_k and seq_q > seq_k, ragged tiles, rows with no key
      or only masked keys, fp32 and bf16);
  (d) GPT-2-small gpt_forward at 8x1024: flash attention against the
      reference attention on the same weights;
  (e) the main path: AdamW(3e-4) steps of GPT-2 small (full remat) at
      batch 8, seq 1024 through the entry points of bench.py:bench_model
      (build_mesh(MeshConfig(data=1)), init_train_state and
      make_train_step with "dp"), with each kernel's launches counted;
      step 0 against the reference-attention step, and two control steps
      with wrong attention that must fail that gate; then one more step
      under torch.profiler: each kernel's device time, the top device
      ops, and the kernels' share of the step;
  (f) each kernel timed with CUDA events beside its plain version and
      PyTorch's scaled_dot_product_attention (forward for K1, backward
      alone for K2 and K3, forward+backward printed beside; timed only
      here, the port never calls it);
  (i) GPT-2 small with MoE (4 experts, top-2, full remat) through the same
      entry points: launches, losses, the aux loss, the routing flips
      between flash and reference attention, and the step-0 gate against
      reference steps that replay each run's routing, with its controls;
  (j) GPT-2 medium (24 layers, 16 heads) with remat "dots": the forward
      gate of (d), the train path of (i) without MoE, and step time and
      peak memory beside a remat "full" run;
  (k) the trainer's other strategies through the same entry points, in a
      world of one (every mesh axis of size 1, as in JAX): "fsdp", "tp"
      and "tp_fsdp" steps of GPT-2 small, each with 2L/L/L launches and
      its step 0 held to (e)'s flash step 0 by (e)'s gate (with every
      axis of size 1 they place nothing and run (e)'s dp code: the
      entry points accept them; their placement runs across cards, in
      tests/test_torch_cuda.py); "sp" with
      attention="ring" (a ring of one: plain PyTorch partials, no kernel)
      through (i)'s train path, gate and controls against reference
      attention; and the dry run's "sp_ep" (ring attention and MoE, 4
      experts) likewise, its reference steps replaying routing;
  (l) GPT-2 small in the pipeline layout under "pp" (pipeline=1, 4
      microbatches), fed by data.feed.device_batch_stream from numpy
      batches: launches 2ML/ML/ML per step at B·H 24, the step-0 gate
      against reference attention with its controls, falling losses, and
      a sharded checkpoint of the state after step 2 whose restored step 3
      equals the uninterrupted step 3 bit for bit;
  (m) RLlib on the card (ray_tpu_torch.rllib), runners and learners built
      with device=None and composed as each algorithm's training_step
      composes them, at the widths the JAX algorithms configure: PPO with
      the legacy MLP on CartPole-v1 (4 envs, 3 iterations of 200 steps,
      minibatch 128, 8 epochs), with the catalog CNN on GridGoal 84x84x1
      (control: the conv map flattened NCHW) and with use_lstm on
      StatelessCartPole (control: no forget-gate bias); one iteration each
      of DQN (dueling off and on), C51, QR-DQN and Noisy DQN on CartPole
      and of R2D2 on MemoryCue. Each first update is gated against the
      port's CPU update of the same batch from the same weights, TF32 off;
      each control must fail the gate. Update times (CUDA events), time
      per env step, and sampling's copies, syncs and idle card under
      torch.profiler. No kernel of K1-K3 runs here;
  (n) RLlib's continuous, offline and podracer compute on the card, at the
      JAX algorithms' widths (RL_OFF), cut to 5 iterations: SAC, SAC with
      PER, TD3 and DDPG on Pendulum-v1 (2 ContinuousEnvRunners x 1 env,
      fragment 64, 500 warm-up steps, batch 256, one update per sampled
      step: 2048 updates in all), composed as their training_step composes
      them; CQL (4 OOD actions) on the SAC run's transitions written by
      offline.JsonWriter and read back by JsonReader; BC and MARWIL on
      CartPole fragments of EnvRunner written and read the same way, 200
      updates each, and a greedy evaluate; five podracer ticks of two
      _RolloutWorkers and a _Learner. Each first update gated against the
      port's CPU update of the same batch from the same weights with the
      same draws (Adam's moment part by part); controls that must fail: SAC's
      actor loss on the critic before its step, TD3's actor stepped every
      update, CQL's logsumexp over the batch axis, MARWIL's weights on the
      old adv_norm. Update times, time per env step, and the continuous
      runner's sampling under torch.profiler;
  (o) every algorithm of ray_tpu_torch.rllib (PPO, PPO multi-agent, A2C,
      PG, IMPALA, APPO, DQN, C51, QR-DQN, Noisy DQN, R2D2, APEX-DQN, SAC,
      TD3, DDPG, CQL, BC, MARWIL, ES, ARS) built from its config and run
      through build().train() with the in-process runtime and the device
      left to its default (the card), at the JAX configs' default widths
      cut in iterations (ALGO_ITERS); each gated against a CPU run of the
      same config from the same weights, TF32 off: sampled batches
      identical, the first updating iteration's loss within 1e-4, runners
      holding the learner's weights; controls that must fail: PPO and DQN
      with the post-update broadcast skipped. A checkpoint round trip on
      the card; iteration ms on the card and on the CPU; for PPO and DQN
      the copies and syncs of one iteration under torch.profiler. No kernel
      of K1-K3 runs here;
  (p) the main path through the port's Train harness: GPT-2 small at (e)'s
      widths, batch and optimizer, trained by Trainer(...).fit() with no
      runtime (a gang of one in this process) on the card, 8 steps with a
      sharded checkpoint after every second (top 2 kept by loss): run A
      raises before step 5 and resumes from the checkpoint after step 3
      (FailureConfig(max_failures=1)), and must equal the uninterrupted run
      B bit for bit in its final loss and TrainState, with 24/12/12
      launches in every step, two checkpoints left (the lowest losses) and
      two attempts; two controls resumed from A's earlier kept checkpoint
      (Adam's moments and count reset; the step counter one early) must
      fail that gate. Step ms in the harness, the cost of a report,
      save_pytree/load_pytree ms and bytes, the restart time and each
      attempt's peak memory;
  (q) the last entry points, in this process (the script does not import
      ray_tpu): (q1) PodracerRun at JAX's default widths with no runtime,
      the learner on the card, 200 ticks beside the same run on the CPU:
      the standing invariants (ticks contiguous, applied == tick + 1, every
      batch present, versions monotonic), the first 3 ticks' learner
      metrics within 1e-4 of the CPU's, a control learner skipping tick 1's
      update that must fail, ticks/s and env steps/s; (q2) GPT-2 small cut
      into 4 GPTStages of 3 layers through StagePipeline (channel depth 4,
      8 microbatches of [2, 1024]), the logits equal bit for bit to the
      same layers run whole on the card, K1 12 launches a microbatch and
      K2, K3 none, ms a microbatch and the bytes a hop; (q3) ``python -m
      ray_tpu_torch rllib train`` (PPO, CartPole-v1, 2 iterations, a
      checkpoint) and ``evaluate`` on the card and the CPU, as
      subprocesses, with JAX's lines, and an unknown --algo with JAX's
      message (in this process); ms an iteration beside (o)'s PPO;
  (g) one line {"kernels": [...]} (launches from the main path, e);
  (h) last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA or without the package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound_ms roofline.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

MAIN = dict(batch=8, heads=12, seq=1024, head_dim=64, dtype=torch.bfloat16)
STEPS = 5          # flash-attention AdamW steps on the main path
REF_STEPS = 3      # reference-attention steps, for step 0 and the A/B
SEED = 0

# Kernel against plain version, element by element:
#     |kernel - plain| <= RTOL[dtype] * (|plain| + |W| |X|)
# where W X is the product that defines the output (P V for o, dS K for dQ,
# dS^T Q for dK, P^T dO for dV) taken in absolute values. This is the
# rounding-error bound of the two sides: both round p and dS to the input
# type at the same points, against the same running max (flash_fwd_plain
# follows K1's 64-key tiles), and differ only in fp32 summation order. In
# bf16 that order can flip the rounding of a single weight of p or dS (one
# ulp, at most 2^-7 of it, so at most 2^-7 |W| |X| summed over the flipped
# terms) and of the output itself (one ulp, at most 2^-7 |plain|). In fp32
# nothing is rounded to a coarser type and 1e-5 covers fp32 summation
# order over these lengths with a tenfold margin. lse is fp32 on both
# sides, in log units: LSE_ATOL absolute; rows with no key match exactly.
# In bf16, dQ and dK add one term that a relative bound cannot cover. dS =
# p (dP - delta), with dP = dO V^T summed in fp32 in another order on each
# side (tensor cores against cuBLAS), each within D units of fp32 rounding
# (2^-23: the tensor cores truncate) of |dO| |V|^T. In a row that sees one
# key, p = 1 and O = V, so dP - delta cancels and dS is that rounding noise
# itself. The term p |dO| |V|^T 2 D 2^-23, carried through |K| and |Q| as
# dS is, bounds the two sides' difference there. In fp32 the CUDA-core
# kernels hold to the relative term alone, which stays their bound
# (PERF.md).
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
FP32_UNIT = 2.0 ** -23
LSE_ATOL = 1e-4
# GPT-2 small in bf16, flash vs reference attention on the same weights:
# the two paths round p at different points in each of 12 layers, so the
# logits agree to bf16 working precision, not bit for bit.
LOGITS_TOL = 5e-2          # max |Δ| over max |reference logits|
# Step 0, flash against reference attention, relative; a few times the
# readings on an H100 (loss 1.6e-5, grad norm 4.0e-4). Two control steps
# with wrong attention (output zeroed; causal mask missing the diagonal)
# must fail them.
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 2e-3
WARMUP, TIMED_RUNS = 3, 20

LIBRARY_CALLS = {
    "flash_fwd": "scaled_dot_product_attention forward",
    "flash_bwd_dq": "scaled_dot_product_attention backward",
    "flash_bwd_dkv": "scaled_dot_product_attention backward",
}
REPLACES = {
    "flash_fwd": "ray_tpu/ops/attention.py:53 _flash_kernel",
    "flash_bwd_dq": "ray_tpu/ops/attention.py:146 _flash_bwd_dq_kernel",
    "flash_bwd_dkv": "ray_tpu/ops/attention.py:199 _flash_bwd_dkv_kernel",
}
# K1-K3 run the tensor-core design of flash_wgmma.cuh on the main path
# (bf16, head dim 64).
SOURCES = {name: "ray_tpu_torch/csrc/flash_wgmma.cuh" for name in REPLACES}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[a] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(f"[a] nvidia-smi --query-gpu=name,power.limit:")
    log(card)
    # fp32 checks must be fp32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[a] torch.backends.cuda.matmul.allow_tf32 = False, "
        "cudnn.allow_tf32 = False")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": card}


# ---------------------------------------------------------------------------
# (b) build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[b] nvcc {_build.find_nvcc()}: built {sorted(built) or 'nothing'} "
        f"in {time.perf_counter() - t0:.1f} s "
        f"(flags {' '.join(_build.NVCC_FLAGS)})")
    for name in built:
        text = _build.library_path(name).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[b]   {line.strip()}")
    _build.load_library("flash_attention")


# ---------------------------------------------------------------------------
# (c) kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, with NEG_INF rows (lse of rows that visit no key, or
    whose keys are all masked) required to match exactly."""
    a, b = a.float(), b.float()
    real = b.abs() < 1e29
    if not torch.equal(a.abs() < 1e29, real):
        return math.inf
    return float((a - b)[real].abs().max()) if real.any() else 0.0


def _bound_ratio(a, b, mag, rtol, extra=0.0) -> float:
    """max over elements of |a - b| / (rtol (|b| + mag) + extra): <= 1
    passes."""
    diff = (a.float() - b.float()).abs()
    bound = rtol * (b.float().abs() + mag) + extra
    ratio = torch.where(diff == 0, 0.0, diff / bound)
    return float(ratio.max()) if ratio.numel() else 0.0


def _magnitudes(q, k, v, do, lse, delta, causal, scale, bq, bk) -> dict:
    """|W| |X| of each output's defining product, from the plain parts,
    and under "dq_sum" / "dk_sum" the bound of dP's fp32 summation order
    carried into dQ and dK (see RTOL)."""
    from ray_tpu_torch.ops import attention as A
    # |P| |V|: the forward over |V| (its P is nonnegative already).
    o_abs, _ = A.flash_fwd_plain(q, k, v.abs(), causal=causal,
                                 sm_scale=scale, block_q=bq, block_k=bk)
    p, ds = A._probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    ds = ds.abs()
    dp_sum = p * torch.matmul(do.float().abs(), v.float().abs().transpose(
        1, 2)) * (2 * q.shape[-1] * FP32_UNIT)
    return {"o": o_abs.float(),
            "dq": scale * torch.matmul(ds, k.float().abs()),
            "dk": scale * torch.matmul(ds.transpose(1, 2), q.float().abs()),
            "dv": torch.matmul(p.transpose(1, 2), do.float().abs()),
            "dq_sum": scale * torch.matmul(dp_sum, k.float().abs()),
            "dk_sum": scale * torch.matmul(dp_sum.transpose(1, 2),
                                           q.float().abs())}


def _inputs(bh, sq, sk, d, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(bh, sq, d), rnd(bh, sk, d), rnd(bh, sk, d), rnd(bh, sq, d)


def check_case(bh, sq, sk, d, dtype, causal, bq, bk, gen) -> dict:
    """Run K1-K3 and their plain versions on the same inputs; returns
    {kernel: (max_abs_err, max bound ratio, passed, max ratio to the
    relative term alone)} and the same for K1's second output under
    "lse"."""
    from ray_tpu_torch.ops import attention as A
    q, k, v, do = _inputs(bh, sq, sk, d, dtype, gen)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, sm_scale=scale)
    o_ref, lse_ref = A.flash_fwd_plain(q, k, v, block_q=bq, block_k=bk, **kw)
    o, lse = A.flash_fwd(q, k, v, block_q=bq, block_k=bk, **kw)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq_ref = A.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, **kw)
    dq = A.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
    dk_ref, dv_ref = A.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
    torch.cuda.synchronize()
    mag = _magnitudes(q, k, v, do, lse_ref, delta, causal, scale, bq, bk)
    rtol = RTOL[dtype]
    lse_err = _max_err(lse, lse_ref)
    bf16 = dtype == torch.bfloat16   # the dP term (see RTOL)
    dq_sum, dk_sum = (mag["dq_sum"], mag["dk_sum"]) if bf16 else (0.0, 0.0)
    pairs = {"flash_fwd": [(o, o_ref, mag["o"], 0.0)],
             "flash_bwd_dq": [(dq, dq_ref, mag["dq"], dq_sum)],
             "flash_bwd_dkv": [(dk, dk_ref, mag["dk"], dk_sum),
                               (dv, dv_ref, mag["dv"], 0.0)]}
    out = {}
    for name, items in pairs.items():
        ratio = max(_bound_ratio(a, b, m, rtol, e) for a, b, m, e in items)
        rel = max(_bound_ratio(a, b, m, rtol) for a, b, m, _ in items)
        abs_err = max(_max_err(a, b) for a, b, _, _ in items)
        out[name] = (abs_err, ratio, ratio <= 1.0, rel)
    out["lse"] = (lse_err, lse_err / LSE_ATOL, lse_err <= LSE_ATOL,
                  lse_err / LSE_ATOL)
    return out


SMALL_CASES = [
    # (bh, seq_q, seq_k, head_dim, dtype, causal, block_q, block_k)
    (3, 128, 128, 32, torch.float32, True, 64, 64),
    (3, 128, 128, 32, torch.float32, False, 64, 64),
    (2, 64, 64, 16, torch.float32, True, 32, 32),
    (2, 64, 192, 64, torch.float32, True, 32, 64),      # seq_q < seq_k
    (2, 96, 32, 64, torch.float32, True, 32, 32),       # rows with no keys
    (2, 64, 32, 32, torch.float32, True, 64, 32),       # masked rows: mean V
    (2, 160, 96, 128, torch.float32, True, 32, 32),     # ragged 64-tiles
    (2, 96, 224, 128, torch.float32, False, 32, 32),
    (4, 128, 128, 32, torch.bfloat16, True, 64, 64),
    (4, 128, 128, 64, torch.bfloat16, False, 64, 64),
    (2, 128, 384, 64, torch.bfloat16, True, 128, 128),  # seq_q < seq_k
    (2, 384, 128, 64, torch.bfloat16, True, 128, 128),  # seq_q > seq_k
    (2, 96, 160, 16, torch.bfloat16, True, 32, 32),
    # bf16 counterparts of the fp32 edge cases: the tensor-core kernels.
    (2, 160, 96, 128, torch.bfloat16, True, 32, 32),    # ragged 64-tiles
    (2, 64, 32, 64, torch.bfloat16, True, 64, 32),      # masked rows: mean V
    (2, 96, 224, 128, torch.bfloat16, False, 32, 32),
    (2, 96, 32, 64, torch.bfloat16, True, 32, 32),      # rows with no keys
    (8, 1024, 1024, 128, torch.bfloat16, True, 128, 128),
]


def phase_kernels() -> dict:
    """Every case is run and printed; then any disagreement raises."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    failed = []

    def run(case, label):
        res = check_case(*case, gen)
        log(f"[c] {label}: " + ", ".join(
            f"{n} max_abs {a:.3e} ratio {r:.3f}"
            + (f" ({rel:.3g} without the dP term)" if rel != r else "")
            + ("" if ok else " FAIL")
            for n, (a, r, ok, rel) in res.items()))
        failed.extend(f"{n} at {label}" for n, (_, _, ok, _) in res.items()
                      if not ok)
        return res

    for case in SMALL_CASES:
        bh, sq, sk, d, dt, causal, bq, bk = case
        run(case, f"bh={bh} sq={sq} sk={sk} d={d} {str(dt)[6:]} "
                  f"causal={causal} blocks=({bq},{bk})")
    m = MAIN
    bh = m["batch"] * m["heads"]
    res = run((bh, m["seq"], m["seq"], m["head_dim"], m["dtype"], True,
               128, 128), f"main shape bh={bh} s={m['seq']} "
                          f"d={m['head_dim']} bf16 causal")
    # GPT-2 medium (phase j): 16 heads at head dim 64.
    run((m["batch"] * 16, m["seq"], m["seq"], m["head_dim"], m["dtype"],
         True, 128, 128), f"gpt2-medium shape bh={m['batch'] * 16} "
                          f"s={m['seq']} d={m['head_dim']} bf16 causal")
    # Phase (l): GPT-2 small's heads over one microbatch of the pipeline.
    bh = m["batch"] // PP_MICROBATCHES * m["heads"]
    run((bh, m["seq"], m["seq"], m["head_dim"], m["dtype"], True, 128, 128),
        f"pp microbatch shape bh={bh} s={m['seq']} d={m['head_dim']} "
        f"bf16 causal")
    log(f"[c] tolerance: |kernel - plain| <= rtol (|plain| + |W||X|), rtol "
        f"fp32 {RTOL[torch.float32]:.0e} bf16 2^-7, plus for bf16 dQ and "
        f"dK p |dO||V|^T D 2^-22 through |K| and |Q|; |lse - plain| <= "
        f"{LSE_ATOL:.0e}; ratio = max |kernel - plain| / tolerance")
    if failed:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failed))
    return {n: max(a, res["lse"][0]) if n == "flash_fwd" else a
            for n, (a, _, _, _) in res.items() if n != "lse"}


# ---------------------------------------------------------------------------
# (d) forward, flash vs reference attention
# ---------------------------------------------------------------------------

def _models(cfg):
    from ray_tpu_torch.models import gpt_init
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash = gpt_init(cfg, device="cuda", generator=gen)
    ref = gpt_init(dataclasses.replace(cfg, attention="reference"),
                   device="cuda", generator=gen)
    ref.load_state_dict(flash.state_dict())
    return flash, ref


def _tokens(cfg, batch, seq):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device="cuda")


def phase_forward(cfg=None, tag="d", label="gpt2-small") -> None:
    from ray_tpu_torch.models import GPTConfig, gpt_forward
    cfg = cfg or GPTConfig.gpt2_small()
    flash, ref = _models(cfg)
    tokens = _tokens(cfg, MAIN["batch"], MAIN["seq"])
    with torch.no_grad():
        lf, _ = gpt_forward(flash, tokens)
        lr, _ = gpt_forward(ref, tokens)
    torch.cuda.synchronize()
    if not torch.isfinite(lf).all():
        raise AssertionError("flash logits are not finite")
    if lf.shape != (MAIN["batch"], MAIN["seq"], cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(lf.shape)}")
    err = float((lf.float() - lr.float()).abs().max())
    rel = err / float(lr.float().abs().max())
    log(f"[{tag}] {label} gpt_forward 8x1024 bf16: logits "
        f"{tuple(lf.shape)}, flash vs reference max |Δ| {err:.3e} = "
        f"{rel:.2e} of max|logit| (tol {LOGITS_TOL:.0e})")
    if not rel <= LOGITS_TOL:
        raise AssertionError(f"flash logits differ from reference: {rel}")
    del flash, ref, lf, lr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (e) the main path: GPT-2-small train steps; the train-path helpers that
# the MoE (i) and GPT-2-medium (j) phases share
# ---------------------------------------------------------------------------

def _run_steps(model, n, batch, around=lambda i: contextlib.nullcontext(),
               strategy="dp", make_loss=None, state=None,
               after=lambda i, state: None):
    """n steps through the entry points of bench.py:bench_model
    (build_mesh, init_train_state and make_train_step with ``strategy``,
    "dp" there), from a fresh optimizer state or from ``state`` (a
    TrainState of ``model``); step i runs inside ``around(i)`` on
    ``batch`` (or ``batch[i]``, a list), and ``after(i, state)`` runs
    after it, outside the clock. ``make_loss(mesh)``: the loss function
    (default gpt_loss)."""
    from ray_tpu_torch.models import gpt_loss
    from ray_tpu_torch.ops.attention import KERNELS
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.train import adamw, init_train_state, make_train_step
    mesh = build_mesh(MeshConfig(data=1))
    opt = adamw(3e-4)
    if state is None:
        state = init_train_state(lambda: model, opt, mesh, strategy)
    loss_fn = gpt_loss if make_loss is None else make_loss(mesh)
    step = make_train_step(loss_fn, opt, mesh, strategy)
    losses, norms, times, counts = [], [], [], []
    for i in range(n):
        before = {k: kern.launches for k, kern in KERNELS.items()}
        torch.cuda.synchronize()
        with around(i):
            t0 = time.perf_counter()
            state, metrics = step(state, batch[i] if isinstance(
                batch, list) else batch)
            loss = float(metrics["loss"])  # host readback ends the step
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        counts.append({k: kern.launches - before[k]
                       for k, kern in KERNELS.items()})
        after(i, state)
    return losses, norms, times, counts


def _zeroed_attention(q, k, v, **_):
    """Control: attention output 0 (connected to q, k, v, zero grads)."""
    return (q + k + v) * 0.0


def _diagonal_missed_attention(q, k, v, **_):
    """Control: causal mask off by one, each query misses its own key."""
    s = q.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(
        q.shape[-1])
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril(-1)
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


CONTROLS = (("attention zeroed", _zeroed_attention),
            ("diagonal missed", _diagonal_missed_attention))


@contextlib.contextmanager
def _moe_routing(model, record=None, replay=None):
    """Inside the body: ``record`` takes each MoE layer's top-k indices of
    its first forward ({layer: [b,s,k]}) and, under "aux", the first aux
    loss; ``replay`` ({layer: indices}) routes every layer by the given
    indices instead of its own top-k, with the weights renormalised from
    this run's router probabilities at those experts."""
    from ray_tpu_torch.models import gpt as G
    if not model.cfg.n_experts:
        yield
        return
    layer_of = {id(layer.moe): i for i, layer in enumerate(model.layers)}
    route, switch_aux = G._route, G._switch_aux

    def routed(moe, x, cfg):
        probs, weights, idx = route(moe, x, cfg)
        i = layer_of[id(moe)]
        if replay is not None:
            idx = replay[i]
            picked = probs.gather(-1, idx)
            weights = picked / picked.sum(dim=-1, keepdim=True)
        if record is not None:
            record.setdefault(i, idx.detach().clone())
        return probs, weights, idx

    def aux(*args):
        out = switch_aux(*args)
        if record is not None:
            record.setdefault("aux", float(out.detach()))
        return out

    G._route, G._switch_aux = routed, aux
    try:
        yield
    finally:
        G._route, G._switch_aux = route, switch_aux


def _step0(cfg, state_dict, batch, attention=None, record=None,
           replay=None, strategy="dp"):
    """Step 0 from ``state_dict``, with the model's flash (or ring)
    attention replaced by ``attention`` where given, and MoE routing
    recorded or replayed: (loss, grad_norm)."""
    from ray_tpu_torch.models import gpt as G
    model = G.gpt_init(cfg, device="cuda")
    model.load_state_dict(state_dict)
    name = "ring_attention" if cfg.attention == "ring" else "flash_attention"
    saved = getattr(G, name)
    if attention is not None:
        setattr(G, name, attention)
    try:
        with _moe_routing(model, record, replay):
            loss, norm, _, _ = _run_steps(model, 1, batch, strategy=strategy)
    finally:
        setattr(G, name, saved)
    return loss[0], norm[0]


def _expected_launches(cfg) -> dict:
    """Per step: K1 once per layer in the forward and once more in the
    backward's recompute (remat "full" and "dots"), K2 and K3 once per
    layer; none under ring attention (no kernel: JAX computes its partials
    with einsums outside any Pallas kernel)."""
    from ray_tpu_torch.models.gpt import _remat_policy
    n = 0 if cfg.attention == "ring" else cfg.n_layers
    fwd = n if _remat_policy(cfg) == "none" else 2 * n
    return {"flash_fwd": fwd, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def _gate(tag, loss, norm, ref, label) -> bool:
    dl = abs(loss - ref[0]) / abs(ref[0])
    dn = abs(norm - ref[1]) / abs(ref[1])
    ok = dl <= LOSS_RTOL and dn <= GRAD_NORM_RTOL
    log(f"[{tag}] step 0 {label}: loss {loss:.5f} rel {dl:.2e} (tol "
        f"{LOSS_RTOL:.0e}), grad_norm {norm:.5f} rel {dn:.2e} (tol "
        f"{GRAD_NORM_RTOL:.0e}): {'pass' if ok else 'fail'}")
    return ok


def _flips(a: dict, b: dict, n_layers: int) -> tuple:
    """(tokens whose top-k set differs, tokens whose top-1 differs, per
    layer the first count) between two recorded routings."""
    per_layer, top1 = [], 0
    for i in range(n_layers):
        sa, sb = a[i].sort(dim=-1).values, b[i].sort(dim=-1).values
        per_layer.append(int((sa != sb).any(dim=-1).sum()))
        top1 += int((a[i][..., 0] != b[i][..., 0]).sum())
    return sum(per_layer), top1, per_layer


def train_path(tag, cfg, label, steps=STEPS, ref_steps=REF_STEPS,
               around=lambda i: contextlib.nullcontext(),
               strategy="dp") -> dict:
    """One path of the trainer at batch 8, seq 1024, AdamW(3e-4), random
    weights from SEED: ``steps`` flash-attention steps with every kernel's
    count set to 0 just before and read just after, checked against
    ``_expected_launches`` in every step; finite, falling losses;
    ``ref_steps`` reference-attention steps; and the step-0 gate, flash
    against reference, which the two wrong-attention controls must fail.

    For MoE, routing is discontinuous (top-k), and flash and reference
    attention, which agree to bf16 rounding, can send a token to other
    experts. So each compared step 0 (flash, each control) records its
    routing, the gate's reference step 0 replays that routing, and the
    gate compares attention alone; the flips between the flash and the
    free reference run, and the free run's readings, are printed."""
    from ray_tpu_torch.models import count_params
    from ray_tpu_torch.models.gpt import _remat_policy
    from ray_tpu_torch.ops.attention import KERNELS
    moe = cfg.n_experts > 0
    flash, ref = _models(cfg)
    # The initial weights, for the control and replay steps; kept on the
    # host so that the flash run's peak memory is the step's own.
    init = {k: v.detach().cpu() for k, v in flash.state_dict().items()}
    bs, seq = MAIN["batch"], MAIN["seq"]
    batch = {"tokens": _tokens(cfg, bs, seq + 1)}
    sname = getattr(strategy, "name", strategy)
    att = cfg.attention
    log(f"[{tag}] {label} {count_params(flash):,} params, bs {bs} seq {seq}, "
        f"remat {_remat_policy(cfg)}, attention {cfg.attention}, AdamW(3e-4), "
        f"entry points build_mesh(MeshConfig(data=1)) -> init_train_state("
        f"..., mesh, {sname!r}) -> make_train_step(..., mesh, {sname!r})")

    routing = {}
    controls = {}
    for name, fn in CONTROLS:
        routing[name] = {}
        controls[name] = _step0(cfg, init, batch, fn, record=routing[name],
                                strategy=strategy)
    routing["reference"] = {}
    with _moe_routing(ref, record=routing["reference"]):
        r_loss, r_norm, r_times, _ = _run_steps(ref, ref_steps, batch,
                                                strategy=strategy)
    del ref
    torch.cuda.empty_cache()

    routing["flash"] = {}
    record = _moe_routing(flash, record=routing["flash"])
    for kern in KERNELS.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    f_loss, f_norm, f_times, f_counts = _run_steps(
        flash, steps, batch,
        around=lambda i: record if i == 0 else around(i), strategy=strategy)
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def ms(ts):
        return 1e3 * statistics.median(ts[1:])
    for i in range(steps):
        log(f"[{tag}] {att} step {i}: loss {f_loss[i]:.5f} grad_norm "
            f"{f_norm[i]:.5f} {1e3 * f_times[i]:.1f} ms launches "
            f"{f_counts[i]}")
    for i in range(ref_steps):
        log(f"[{tag}] reference step {i}: loss {r_loss[i]:.5f} grad_norm "
            f"{r_norm[i]:.5f} {1e3 * r_times[i]:.1f} ms")
    f_ms, r_ms = ms(f_times), ms(r_times)
    log(f"[{tag}] {att}: step {f_ms:.1f} ms (median of steps 1-"
        f"{steps - 1}), {bs * seq / f_ms * 1e3:,.0f} tok/s, peak memory "
        f"{peak_gb:.1f} GB")
    log(f"[{tag}] reference: step {r_ms:.1f} ms (median of steps "
        f"1-{ref_steps - 1}), {bs * seq / r_ms * 1e3:,.0f} tok/s")
    log(f"[{tag}] launches over {steps} steps: {launches}")

    expected = _expected_launches(cfg)
    for i, c in enumerate(f_counts):
        if c != expected:
            raise AssertionError(f"{label} step {i} launches {c} != "
                                 f"{expected}")
    if not all(math.isfinite(x) for x in f_loss + f_norm):
        raise AssertionError(f"non-finite loss or grad norm: {f_loss}")
    if not f_loss[-1] < f_loss[0]:
        raise AssertionError(f"loss did not fall: {f_loss}")

    free = (r_loss[0], r_norm[0])
    if moe:
        aux = routing["flash"]["aux"]
        log(f"[{tag}] step 0 aux loss (Switch, summed over {cfg.n_layers} "
            f"layers): {aux:.5f} (perfect balance: {cfg.n_layers}; at most "
            f"{cfg.n_layers * cfg.n_experts}); in the loss as 0.01 aux / "
            f"n_layers = {0.01 * aux / cfg.n_layers:.5f}")
        if not 0 < aux <= cfg.n_layers * cfg.n_experts:
            raise AssertionError(f"aux loss {aux} outside (0, L e]")
        total, top1, per_layer = _flips(routing["flash"],
                                        routing["reference"], cfg.n_layers)
        decisions = bs * seq * cfg.n_layers
        log(f"[{tag}] routing flips, {att} vs reference step 0: top-"
            f"{cfg.expert_top_k} set differs for {total} of {decisions} "
            f"token-layers ({100 * total / decisions:.3f}%), top-1 for "
            f"{top1}; per layer {per_layer}")
        _gate(tag, f_loss[0], f_norm[0], free,
              f"{att} vs reference, routing free (printed, not gated)")
        refs = {name: _step0(dataclasses.replace(cfg, attention="reference"),
                             init, batch, replay=routing[name],
                             strategy=strategy)
                for name in ["flash"] + [n for n, _ in CONTROLS]}
        how = "vs reference with its routing replayed"
    else:
        refs = {name: free for name in ["flash"] + [n for n, _ in CONTROLS]}
        how = "vs reference"
    if not _gate(tag, f_loss[0], f_norm[0], refs["flash"], f"{att} {how}"):
        raise AssertionError(f"{label}: step 0 differs from the reference "
                             "step")
    passed = [name for name, res in controls.items()
              if _gate(tag, *res, refs[name], f"control ({name}) {how}")]
    if passed:
        raise AssertionError(f"{label}: the step-0 gate passes wrong "
                             f"attention: {passed}")
    return dict(model=flash, batch=batch, launches=launches, step_ms=f_ms,
                peak_gb=peak_gb, step0=(f_loss[0], f_norm[0]))


def _device_us(ev) -> float:
    """Self device time of a profiler entry, in us (the attribute's name
    differs between PyTorch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return float(getattr(ev, attr))
    return 0.0


def _profile_step(model, batch, tag="e", label="flash step", top=10,
                  **steps) -> None:
    """One warm-up step, then one step under torch.profiler: each kernel's
    device time in the step, the top ``top`` device ops by time, and the
    kernels' share of the step's device time. ``steps``: ``_run_steps``'s
    strategy and loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, _, times, counts = _run_steps(
        model, 2, batch,
        around=lambda i: prof if i == 1 else contextlib.nullcontext(),
        **steps)
    ops = [(e.key, e.count, _device_us(e) / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    device_ms = sum(ms for _, _, ms in ops)
    log(f"[{tag}] profile of one {label} (torch.profiler, after one "
        f"warm-up step): {1e3 * times[-1]:.1f} ms on the host clock, device "
        f"time {device_ms:.2f} ms over {len(ops)} device ops")
    if not ops:
        log(f"[{tag}]   the profiler recorded no device time")
        return
    kernel_ms = 0.0
    for name in REPLACES:
        mine = [(c, ms) for key, c, ms in ops if name + "_" in key]
        n, ms = sum(c for c, _ in mine), sum(ms for _, ms in mine)
        kernel_ms += ms
        log(f"[{tag}]   {name}: {n} launches in the profile "
            f"({counts[-1][name]} counted), {ms:.3f} ms device, "
            f"{ms / max(n, 1):.4f} ms each")
    log(f"[{tag}]   K1-K3 together: {kernel_ms:.3f} ms = "
        f"{100 * kernel_ms / device_ms:.1f}% of the step's device time, "
        f"{100 * kernel_ms / (1e3 * times[-1]):.1f}% of its host-clock time")
    log(f"[{tag}]   top {top} device ops by time (ms, calls, share of device "
        f"time):")
    for key, c, ms in sorted(ops, key=lambda x: -x[2])[:top]:
        log(f"[{tag}]     {ms:8.3f} ms {c:5d}x {100 * ms / device_ms:5.1f}%  "
            f"{key[:110]}")


def phase_train() -> tuple:
    """(e) GPT-2 small, dense, remat full: the main path. -> (launches,
    flash step 0's (loss, grad_norm), step ms)."""
    from ray_tpu_torch.models import GPTConfig
    res = train_path("e", GPTConfig.gpt2_small(), "gpt2-small")
    _profile_step(res["model"], res["batch"])  # after the counted steps
    out = res["launches"], res["step0"], res["step_ms"]
    del res
    torch.cuda.empty_cache()
    return out


def phase_moe() -> dict:
    """(i) GPT-2 small with MoE (n_experts 4, top-2), remat full."""
    from ray_tpu_torch.models import GPTConfig
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_experts=4,
                              expert_top_k=2)
    res = train_path("i", cfg, "gpt2-small moe e=4 top-2")
    _profile_step(res["model"], res["batch"], "i", "moe step", top=5)
    launches = res["launches"]
    del res
    torch.cuda.empty_cache()
    return launches


def phase_medium() -> dict:
    """(j) GPT-2 medium (d 1024, 24 layers, 16 heads: B·H 128) with remat
    "dots": the forward gate of (d), the train path, and a "full" run of
    the same steps for step time and peak memory beside it."""
    from ray_tpu_torch.models import GPTConfig, gpt_init
    cfg = dataclasses.replace(GPTConfig.gpt2_medium(), remat_policy="dots")
    phase_forward(cfg, "j", "gpt2-medium")
    res = train_path("j", cfg, "gpt2-medium remat dots")
    _profile_step(res["model"], res["batch"], "j", "remat dots step", top=5)
    launches, dots_ms, dots_gb = (res["launches"], res["step_ms"],
                                  res["peak_gb"])
    del res
    torch.cuda.empty_cache()
    full = dataclasses.replace(cfg, remat_policy="full")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = gpt_init(full, device="cuda", generator=gen)
    batch = {"tokens": _tokens(full, MAIN["batch"], MAIN["seq"] + 1)}
    torch.cuda.reset_peak_memory_stats()
    _, _, times, counts = _run_steps(model, REF_STEPS, batch)
    full_ms = 1e3 * statistics.median(times[1:])
    full_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(c != _expected_launches(full) for c in counts):
        raise AssertionError(f"gpt2-medium remat full launches {counts}")
    _profile_step(model, batch, "j", "remat full step", top=5)
    tok = MAIN["batch"] * MAIN["seq"]
    log(f"[j] gpt2-medium step, remat dots: {dots_ms:.1f} ms "
        f"({tok / dots_ms * 1e3:,.0f} tok/s), peak memory {dots_gb:.1f} GB; "
        f"remat full: {full_ms:.1f} ms ({tok / full_ms * 1e3:,.0f} tok/s), "
        f"peak memory {full_gb:.1f} GB")
    del model
    torch.cuda.empty_cache()
    return launches


K_STEPS = 3        # steps of each strategy in phase (k)


def phase_strategies(e_step0) -> None:
    """(k) the trainer's strategies in a world of one, at GPT-2-small
    width, batch 8, seq 1024, bf16, remat full (module doc). ``e_step0``:
    (e)'s flash step 0 (loss, grad_norm), the gate's reference for the
    sharded presets, which run the same weights and tokens."""
    from ray_tpu_torch.models import GPTConfig, gpt_init
    from ray_tpu_torch.ops.attention import KERNELS
    from ray_tpu_torch.parallel import ShardingStrategy
    cfg = GPTConfig.gpt2_small()
    batch = {"tokens": _tokens(cfg, MAIN["batch"], MAIN["seq"] + 1)}
    expected = _expected_launches(cfg)
    tok = MAIN["batch"] * MAIN["seq"]
    for name in ("fsdp", "tp", "tp_fsdp"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = gpt_init(cfg, device="cuda", generator=gen)
        for kern in KERNELS.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times, counts = _run_steps(model, K_STEPS, batch,
                                                  strategy=name)
        launches = {k: kern.launches for k, kern in KERNELS.items()}
        step_ms = 1e3 * statistics.median(times[1:])
        log(f"[k] {name}: losses {[round(x, 5) for x in losses]}, grad norms "
            f"{[round(x, 5) for x in norms]}, step {step_ms:.1f} ms "
            f"({tok / step_ms * 1e3:,.0f} tok/s, median of steps 1-"
            f"{K_STEPS - 1}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, launches over "
            f"{K_STEPS} steps {launches}")
        if any(c != expected for c in counts):
            raise AssertionError(f"{name} launches {counts} != {expected}")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: loss did not fall: {losses}")
        if not _gate("k", losses[0], norms[0], e_step0,
                     f"{name} vs (e)'s flash dp step 0"):
            raise AssertionError(f"{name}: step 0 differs from (e)'s dp step")
        del model
        torch.cuda.empty_cache()
    ring = dataclasses.replace(cfg, attention="ring")
    res = train_path("k", ring, "gpt2-small sp, ring attention (a ring of "
                     "one)", steps=K_STEPS, ref_steps=2, strategy="sp")
    _profile_step(res["model"], res["batch"], "k", "ring step", top=5)
    del res
    torch.cuda.empty_cache()
    sp_ep = dataclasses.replace(ring, n_experts=4, expert_top_k=2)
    res = train_path("k", sp_ep, "gpt2-small sp_ep, ring attention + MoE e=4 "
                     "top-2", steps=K_STEPS, ref_steps=2,
                     strategy=ShardingStrategy.sp_ep())
    _profile_step(res["model"], res["batch"], "k", "sp_ep step", top=5)
    del res
    torch.cuda.empty_cache()


PP_MICROBATCHES = 4   # phase (l): 2 rows each at batch 8
PP_STEPS = 4          # the checkpoint is saved after step 2, step 3 replayed
PP_SAVE_AFTER = 2


def _pp_steps(model, n, batches, attention=None, **steps):
    """``_run_steps`` of the pipeline layout under "pp": the GPipe loss of
    parallel.pipeline with PP_MICROBATCHES, attention replaced by
    ``attention`` (the controls) where given."""
    from ray_tpu_torch.parallel import pipeline as P
    saved = P.flash_attention
    if attention is not None:
        P.flash_attention = attention
    try:
        return _run_steps(model, n, batches, strategy="pp", make_loss=(
            lambda mesh: P.make_gpt_pp_loss(model.cfg, mesh,
                                            PP_MICROBATCHES)), **steps)
    finally:
        P.flash_attention = saved


def _stacked(cfg, weights):
    """A StackedGPT on the card from ``weights`` ({name: tensor})."""
    from ray_tpu_torch.parallel.pipeline import StackedGPT
    return StackedGPT(cfg, {k: v.to("cuda", copy=True)
                            for k, v in weights.items()})


def phase_pipeline() -> None:
    """(l) GPT-2 small in the pipeline layout (parallel.pipeline.StackedGPT)
    under "pp" in a world of one (pipeline=1, as in JAX), batch 8, seq 1024,
    bf16, remat full, PP_MICROBATCHES microbatches, through build_mesh ->
    init_train_state(..., mesh, "pp") -> make_train_step(make_gpt_pp_loss);
    the batches come through data.feed.device_batch_stream from a numpy
    iterator and must arrive on the card equal to the source rows. Gates:
    step 0 against reference attention on the same stacked weights, which
    two wrong-attention controls must fail; losses finite and falling;
    launches exactly 2ML/ML/ML per step at B·H (B/M)·H. Then the checkpoint
    round trip: the state after step 2 saved (train.checkpoint) to a
    temporary directory and loaded into a fresh model; step 3 from it must
    equal the uninterrupted step 3 bit for bit, in the loss and in every
    parameter. The directory is deleted."""
    import itertools
    import shutil
    import tempfile

    from ray_tpu_torch.data import device_batch_stream
    from ray_tpu_torch.models import GPTConfig, count_params, gpt_init
    from ray_tpu_torch.ops.attention import KERNELS
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel import pipeline as P
    from ray_tpu_torch.train import adamw, init_train_state, load_pytree
    from ray_tpu_torch.train import save_pytree
    cfg = GPTConfig.gpt2_small()
    bs, seq, m = MAIN["batch"], MAIN["seq"], PP_MICROBATCHES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash = P.gpt_params_to_pp(gpt_init(cfg, device="cuda", generator=gen))
    init = {k: v.detach().cpu() for k, v in flash.state_dict().items()}
    log(f"[l] gpt2-small stacked layout ({count_params(flash):,} params, "
        f"stacked.attn.wq {tuple(flash.stacked.attn.wq.shape)}), bs {bs} "
        f"seq {seq}, {m} microbatches of {bs // m} rows, remat full, "
        f"AdamW(3e-4), entry points build_mesh(MeshConfig(data=1)) -> "
        f"init_train_state(..., mesh, 'pp') -> make_train_step("
        f"make_gpt_pp_loss(cfg, mesh, {m}), ..., mesh, 'pp')")

    source = {"tokens": _tokens(cfg, bs, seq + 1).cpu().numpy()}
    mesh = build_mesh(MeshConfig(data=1))
    batches = list(device_batch_stream(itertools.repeat(source, PP_STEPS),
                                       mesh, "pp"))
    torch.cuda.synchronize()
    for b in batches:
        t = b["tokens"]
        if t.device.type != "cuda" or not torch.equal(
                t.cpu(), torch.from_numpy(source["tokens"])):
            raise AssertionError(f"fed batch on {t.device}, dtype {t.dtype}, "
                                 "differs from the source rows")
    log(f"[l] data feed: {len(batches)} batches of {tuple(t.shape)} "
        f"{t.dtype} on {t.device}, equal to the numpy source rows")

    controls = {name: _pp_steps(_stacked(cfg, init), 1, batches, fn)
                for name, fn in CONTROLS}
    controls = {name: (res[0][0], res[1][0]) for name, res in
                controls.items()}
    ref_cfg = dataclasses.replace(cfg, attention="reference")
    r_loss, r_norm, r_times, _ = _pp_steps(_stacked(ref_cfg, init), 2,
                                           batches)
    torch.cuda.empty_cache()

    heads = []

    def attention(q, k, v, **kw):
        heads.append(q.shape[0] * q.shape[1])
        return P_flash(q, k, v, **kw)
    P_flash = P.flash_attention
    P.flash_attention = attention
    kept = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")

    def after(i, state):
        if i == PP_SAVE_AFTER:
            save_pytree(state, tmp)
        kept["state"] = state
    for kern in KERNELS.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        f_loss, f_norm, f_times, f_counts = _pp_steps(
            flash, PP_STEPS, batches, after=after)
    finally:
        P.flash_attention = P_flash
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i in range(PP_STEPS):
        log(f"[l] flash step {i}: loss {f_loss[i]:.5f} grad_norm "
            f"{f_norm[i]:.5f} {1e3 * f_times[i]:.1f} ms launches "
            f"{f_counts[i]}")
    step_ms = 1e3 * statistics.median(f_times[1:])
    log(f"[l] flash: step {step_ms:.1f} ms (median of steps 1-"
        f"{PP_STEPS - 1}), {bs * seq / step_ms * 1e3:,.0f} tok/s, peak "
        f"memory {peak_gb:.1f} GB; reference steps {r_loss} in "
        f"{[round(1e3 * t, 1) for t in r_times]} ms")
    log(f"[l] launches over {PP_STEPS} steps: {launches}; B·H of the "
        f"attention calls: {sorted(set(heads))}")
    n = m * cfg.n_layers
    expected = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    if any(c != expected for c in f_counts):
        raise AssertionError(f"pp launches {f_counts} != {expected}")
    if set(heads) != {bs // m * cfg.n_heads}:
        raise AssertionError(f"pp attention at B·H {sorted(set(heads))}")
    if not all(math.isfinite(x) for x in f_loss + f_norm):
        raise AssertionError(f"pp: non-finite loss or grad norm: {f_loss}")
    if not f_loss[-1] < f_loss[0]:
        raise AssertionError(f"pp: loss did not fall: {f_loss}")
    ref = (r_loss[0], r_norm[0])
    if not _gate("l", f_loss[0], f_norm[0], ref, "pp flash vs reference"):
        raise AssertionError("pp: step 0 differs from the reference step")
    passed = [name for name, res in controls.items()
              if _gate("l", *res, ref, f"pp control ({name})")]
    if passed:
        raise AssertionError(f"pp: the step-0 gate passes wrong attention: "
                             f"{passed}")

    # The checkpoint round trip: step 3 from the state saved after step 2.
    done = kept.pop("state")
    want = {n_: p.detach().clone() for n_, p in
            done.params.named_parameters()}
    del done, flash
    torch.cuda.empty_cache()
    try:
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp))
        fresh = _stacked(cfg, init)
        state = init_train_state(lambda: fresh, adamw(3e-4), mesh, "pp")
        state = load_pytree(tmp, state=state)
        loss, _, _, _ = _pp_steps(fresh, 1, batches[PP_SAVE_AFTER + 1:],
                                  state=state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = [n_ for n_, p in fresh.named_parameters()
            if not torch.equal(p.detach(), want[n_])]
    log(f"[l] checkpoint after step {PP_SAVE_AFTER}: {size / 1e9:.2f} GB "
        f"(state.h0.npz, state.index.json, state.leaves.json; deleted), "
        f"restored into a fresh model at step {state.step}: step "
        f"{PP_SAVE_AFTER + 1} loss {loss[0]!r} against {f_loss[-1]!r} "
        f"uninterrupted; parameters differing: {same or 'none'}")
    if loss[0] != f_loss[PP_SAVE_AFTER + 1] or same:
        raise AssertionError("pp: the restored step differs from the "
                             "uninterrupted one")
    del fresh, state, want
    torch.cuda.empty_cache()
    _profile_step(_stacked(cfg, init), batches[0], "l", "pp step", top=5,
                  strategy="pp", make_loss=lambda mesh: P.make_gpt_pp_loss(
                      cfg, mesh, PP_MICROBATCHES))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (m) RLlib on the card
# ---------------------------------------------------------------------------

# The widths the JAX algorithms configure: AlgorithmConfig's hidden
# (64, 64), fragment 200, minibatch 128, 8 epochs, lr 5e-4
# (ray_tpu/rllib/algorithm.py:26-32) for PPO; DQNConfig's fragment 32 and
# train batch 64 (dqn.py:31-42), C51's 51 atoms on [-10, 10], QR-DQN's 32
# quantiles, Noisy DQN's sigma0 0.5 and R2D2's 16-step sequences, LSTM cell
# 32 and 16 sequences a batch, each its config's default.
RL = dict(hidden=(64, 64), fragment=200, minibatch=128, epochs=8, lr=5e-4,
          envs=4)
RL_Q = dict(fragment=32, batch=64, r2d2_fragment=16, r2d2_cell=32,
            r2d2_batch=16, epsilon=0.5, updates=2)
# The gate: the card's first update against the port's CPU update of the
# same batch from the same weights, TF32 off on the card (phase a):
#   - the loss (PPO: the update's mean total loss) within RL_LOSS_RTOL,
#     relative;
#   - Adam's first moment after the update (an average of the update's
#     gradients) within RL_MOMENT_RTOL of the CPU's in relative L2;
#   - each parameter within Adam's own reach of the CPU's, 2 lr per step.
# The parameters are not held closer: Adam's step m / (sqrt(v) + eps)
# turns a gradient that is rounding noise (|g| near eps) into a step of up
# to lr whose size and sign the two devices need not share, and one such
# element in 11,000 moves the update's relative L2 by 2e-4 (C51, an H100
# run: 2.48e-4, max |param diff| 1.28e-5, loss equal). The bounds are
# several times the readings on an H100 (loss at most 1.6e-5, PPO's CNN,
# whose mean loss is near 0; moment at most 3.3e-6, C51); the controls
# read 4e-2 and more on the loss and 0.33 and more on the moment.
RL_LOSS_RTOL = 1e-4
RL_MOMENT_RTOL = 3e-5
RL_TIMED = 3           # update repeats timed with CUDA events
RL_PROFILED_STEPS = 20


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _nchw_flatten(x):
    """Control: the conv map flattened in torch's NCHW order."""
    return x.reshape(x.shape[0], -1)


def _cell_without_forget_bias(lstm, x, h, c):
    """Control: the LSTM cell without the +1.0 on the forget gate."""
    i, f, g, o = (x @ lstm.wx + h @ lstm.wh + lstm.b).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _after(learner, w0, steps) -> dict:
    """What a gate reads of an update: theta - theta_0 and Adam's first
    moment per parameter (fp64, host; zeros where no gradient came), and
    the number of Adam steps. A learner with one Adam per part (the SAC
    family's ``optimizers``) reads each part's from its own."""
    state = {}
    for opt in (getattr(learner, "optimizers", {}).values()
                or [learner.optimizer]):
        state.update(opt.state)
    weights = learner.get_weights()
    delta, moment = {}, {}
    for k, p in learner.module.named_parameters():
        delta[k] = weights[k].double().cpu() - w0[k].double().cpu()
        st = state.get(p)
        moment[k] = (st["exp_avg"].double().cpu() if st
                     else torch.zeros(p.shape, dtype=torch.float64))
    return dict(delta=delta, moment=moment, steps=steps)


def _steps(metrics) -> int:
    return int(metrics.get("num_minibatch_updates", 1))


def _rl_ref(make, w0, run, device="cpu"):
    """A fresh learner on ``device`` holding w0 (and its target, as after
    sync_target): one update by ``run``. -> (metrics, _after, host s)."""
    learner = make(device)
    learner.set_weights(w0)
    if hasattr(learner, "target"):
        learner.sync_target()
    t0 = time.perf_counter()
    metrics = run(learner)
    seconds = time.perf_counter() - t0
    return metrics, _after(learner, w0, _steps(metrics)), seconds


def _rel_l2(a: dict, b: dict) -> float:
    num = math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in b))
    den = math.sqrt(sum(float((v ** 2).sum()) for v in b.values()))
    return num / max(den, 1e-30)


def _rel_l2_parts(a: dict, b: dict) -> float:
    """The largest _rel_l2 over the parts a state's names start with
    (actor, critic, log_alpha; pi, vf), so that one network's moment is
    not hidden in another's norm: a part all zero on both sides is left
    out, one zero in ``b`` alone reads inf."""
    parts = {}
    for k in b:
        parts.setdefault(k.split(".")[0], []).append(k)
    rels = []
    for ks in parts.values():
        num = max(float(a[k].abs().max()) for k in ks)
        den = max(float(b[k].abs().max()) for k in ks)
        if den:
            rels.append(_rel_l2({k: a[k] for k in ks}, {k: b[k] for k in ks}))
        elif num:
            rels.append(math.inf)
    return max(rels, default=0.0)


def _rl_gate(tag, label, card, ref, loss_key, lr=None,
             parts=False) -> bool:
    """``lr``: the largest learning rate of the learner (RL's by default);
    ``parts``: hold Adam's first moment part by part (_rel_l2_parts)."""
    (mc, ac), (mr, ar) = card, ref
    lc, lr_ = float(mc[loss_key]), float(mr[loss_key])
    loss_rel = abs(lc - lr_) / max(abs(lr_), 1e-30)
    moment_rel = (_rel_l2_parts if parts else _rel_l2)(ac["moment"],
                                                       ar["moment"])
    max_abs = max(float((ac["delta"][k] - ar["delta"][k]).abs().max())
                  for k in ar["delta"])
    reach = 2 * (lr or RL["lr"]) * ar["steps"]
    ok = (math.isfinite(lc) and loss_rel <= RL_LOSS_RTOL
          and moment_rel <= RL_MOMENT_RTOL and max_abs <= reach)
    log(f"[{tag}] gate {label}: {loss_key} {lc:.6g} against the CPU's "
        f"{lr_:.6g}, rel {loss_rel:.2e} (tol {RL_LOSS_RTOL:.0e}); Adam's "
        f"first moment rel {moment_rel:.2e} (tol {RL_MOMENT_RTOL:.0e}); "
        f"max |param diff| {max_abs:.2e} (reach {reach:.1e} in "
        f"{ar['steps']} steps); update rel "
        f"{_rel_l2(ac['delta'], ar['delta']):.2e} (printed): "
        f"{'pass' if ok else 'fail'}")
    return ok


def _rl_controls(tag, make, w0, run, ref, loss_key, controls) -> None:
    for label, module, name, value in controls:
        with _patched(module, name, value):
            card = _rl_ref(make, w0, run, device=None)[:2]
        if _rl_gate(tag, f"control, {label} (must fail)", card, ref,
                    loss_key):
            raise AssertionError(f"{tag}: the control '{label}' passed the "
                                 "gate")


def _rl_time_update(make, w0, run) -> float:
    """Median CUDA-event ms of RL_TIMED updates of a fresh card learner from
    w0 (the first, a warm-up, is left out)."""
    learner = make(None)
    learner.set_weights(w0)
    run(learner)
    times = []
    for _ in range(RL_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(learner)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rl_report(tag, label, card_ms, cpu_s, sample_s, steps, envs) -> None:
    log(f"[{tag}] {label}: update {card_ms:.2f} ms on the card (CUDA "
        f"events, median of {RL_TIMED}), {1e3 * cpu_s:.2f} ms on the CPU "
        f"(host clock, one update); sampling {1e3 * sample_s / steps:.3f} ms "
        f"per vectorized step of {envs} envs, "
        f"{1e3 * sample_s / (steps * envs):.3f} ms per env step (host "
        f"clock, {steps} steps)")


def _profile_counts(fn) -> tuple:
    """``fn()`` under torch.profiler: -> (device-to-host copies,
    host-to-device copies, kernels, cudaMemcpy(Async) calls, stream or
    device syncs, device ms, host ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    d2h = h2d = kernels = copies = syncs = 0
    device_ms = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device_ms += _device_us(e) / 1e3
            if "DtoH" in e.key:
                d2h += e.count
            elif "HtoD" in e.key:
                h2d += e.count
            elif "Memset" not in e.key:
                kernels += e.count
        elif e.key in ("cudaMemcpyAsync", "cudaMemcpy"):
            copies += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += e.count
    return d2h, h2d, kernels, copies, syncs, device_ms, host_ms


def _rl_profile_sampling(tag, runner, label, sample=None,
                         closing=1) -> None:
    """RL_PROFILED_STEPS vectorized steps of ``runner.sample`` (or of
    ``sample(steps)``) under torch.profiler: device-to-host and
    host-to-device copies, kernels and device time per step, against the
    host clock. ``closing``: forwards after the last step (the fragment's
    bootstrap)."""
    sample = sample or runner.sample
    sample(2)
    d2h, h2d, kernels, copies, syncs, device_ms, host_ms = _profile_counts(
        lambda: sample(RL_PROFILED_STEPS))
    n = RL_PROFILED_STEPS + closing
    log(f"[{tag}] {label} sampling under torch.profiler, {RL_PROFILED_STEPS} "
        f"vectorized steps (+{closing} closing forward), per step: "
        f"{d2h / n:.2f} "
        f"device-to-host and {h2d / n:.2f} host-to-device copies "
        f"({copies / n:.2f} cudaMemcpy(Async) calls, {syncs / n:.2f} "
        f"stream syncs), {kernels / n:.1f} kernels, device "
        f"{device_ms / n:.4f} ms of {host_ms / n:.3f} ms on the host clock "
        f"(the card idle {100 * (1 - device_ms / host_ms):.1f}% of it)")


def _rl_ppo(tag, label, env, env_config, model, iterations,
            controls=()):
    """PPO through its entry points: EnvRunner.sample -> concat_samples ->
    PPOLearner.update -> EnvRunner.set_weights, runner and learner on the
    card (device=None). -> the runner."""
    from ray_tpu_torch.rllib.catalog import obs_shape_of
    from ray_tpu_torch.rllib.env import make_env
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.learner import PPOLearner
    from ray_tpu_torch.rllib.sample_batch import concat_samples
    probe = make_env(env, env_config)
    kw = dict(hidden=RL["hidden"], lr=RL["lr"], seed=SEED,
              obs_shape=obs_shape_of(probe), model=model,
              seq_len=RL["fragment"])

    def make(device):
        return PPOLearner(probe.observation_dim, probe.num_actions,
                          device=device, **kw)

    learner = make(None)
    runner = EnvRunner(env, env_config, RL["envs"], SEED,
                       hidden=RL["hidden"], model=model)
    runner.set_weights(learner.get_weights())
    upd = dict(minibatch_size=RL["minibatch"], num_epochs=RL["epochs"])
    sample_s = []
    for it in range(iterations):
        t0 = time.perf_counter()
        batch = concat_samples([runner.sample(RL["fragment"])])
        sample_s.append(time.perf_counter() - t0)
        run = lambda ln, it=it: ln.update(batch, seed=it, **upd)  # noqa
        w0 = learner.get_weights()
        metrics = run(learner)
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{tag} {label}: metrics {metrics}")
        log(f"[{tag}] {label} iteration {it}: {len(batch)} steps, "
            f"{metrics['num_minibatch_updates']} minibatch updates, "
            f"total_loss {metrics['total_loss']:.5f}, vf_loss "
            f"{metrics['vf_loss']:.4f}, entropy {metrics['entropy']:.5f}, "
            f"episodes ended {len(runner.episode_rewards(clear=False))}")
        if it == 0:
            ref_m, ref_d, cpu_s = _rl_ref(make, w0, run)
            ref = (ref_m, ref_d)
            if not _rl_gate(tag, f"{label}, first update", (
                    metrics, _after(learner, w0, _steps(metrics))), ref,
                    "total_loss"):
                raise AssertionError(f"{tag}: {label} failed the gate")
            _rl_controls(tag, make, w0, run, ref, "total_loss", controls)
            first = (w0, run)
        runner.set_weights(learner.get_weights())
    card_ms = _rl_time_update(make, *first)
    _rl_report(tag, f"PPO {label}", card_ms, cpu_s,
               statistics.median(sample_s), RL["fragment"], RL["envs"])
    return runner


def _rl_q(tag, label, make, make_runner, sequences=False,
          update_kw=lambda device: {}) -> None:
    """One iteration of a value-based algorithm as its training_step runs
    it: sample (transitions, or R2D2's sequences), add to a ReplayBuffer,
    RL_Q["updates"] replayed updates, sync the target, weights back to the
    runner. The first update is gated; ``update_kw(device)`` gives extra
    update arguments for the gated update (Noisy DQN's noise)."""
    from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
    learner = make(None)
    runner = make_runner()
    runner.set_weights(learner.get_weights())
    t0 = time.perf_counter()
    if sequences:
        steps, size = RL_Q["r2d2_fragment"], RL_Q["r2d2_batch"]
        batch = runner.sample_sequences(steps, RL_Q["epsilon"])
    else:
        steps, size = RL_Q["fragment"], RL_Q["batch"]
        batch = runner.sample_transitions(steps, RL_Q["epsilon"])
    sample_s = time.perf_counter() - t0
    replay = ReplayBuffer(50_000, seed=SEED)
    replay.add(batch)
    losses = []
    for u in range(RL_Q["updates"]):
        replayed = replay.sample(size)
        if u == 0:
            w0 = learner.get_weights()

            def run(ln, replayed=replayed):
                return ln.update(replayed, **update_kw(ln.device))
            m = run(learner)
            ref_m, ref_d, cpu_s = _rl_ref(make, w0, run)
            if not _rl_gate(tag, f"{label}, first update",
                            (m, _after(learner, w0, 1)), (ref_m, ref_d),
                            "loss"):
                raise AssertionError(f"{tag}: {label} failed the gate")
        else:
            m = learner.update(replayed)
        if not (math.isfinite(m["loss"])
                and torch.isfinite(torch.as_tensor(m["td_error"])).all()):
            raise AssertionError(f"{tag} {label}: loss {m['loss']}")
        losses.append(m["loss"])
    learner.sync_target()
    runner.set_weights(learner.get_weights())
    kind = "sequences" if sequences else "transitions"
    log(f"[{tag}] {label}: {len(batch)} {kind} replayed in batches of "
        f"{size}, losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}, target synced")
    card_ms = _rl_time_update(make, w0, run)
    _rl_report(tag, label, card_ms, cpu_s, sample_s, steps,
               len(runner._envs))


def phase_rllib() -> None:
    """(m) RLlib on the card: runners and learners built with device=None
    (the card), composed as each algorithm's training_step composes them.
    (1) PPO, legacy MLP, CartPole-v1; (2) PPO with the catalog CNN on
    GridGoal 84x84x1 (the catalog's largest default filters), with the
    control of an NCHW flatten; (3) PPO with use_lstm on StatelessCartPole,
    with the control of a cell without the forget-gate bias; (4) one
    iteration each of DQN (dueling off and on), C51, QR-DQN and Noisy DQN
    on CartPole, and of R2D2 on MemoryCue. Every first update is gated
    against the port's CPU update of the same batch from the same weights
    (RL_LOSS_RTOL, RL_MOMENT_RTOL); each control must fail that gate. Then
    the update times (CUDA events) and the time per env step (host
    clock), and the host syncs of sampling under torch.profiler."""
    from ray_tpu_torch.rllib import catalog
    from ray_tpu_torch.rllib.algorithms import c51, dqn, noisy, qrdqn, r2d2
    from ray_tpu_torch.rllib.catalog import obs_shape_of
    from ray_tpu_torch.rllib.env import make_env
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.models import seeded
    # The gates hold the card to the CPU in fp32: no TF32 (as phase a).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[m] torch.backends.cuda.matmul.allow_tf32 = False, "
        "cudnn.allow_tf32 = False")
    mlp = _rl_ppo("m", "mlp CartPole-v1", "CartPole-v1", {}, None, 3)
    _rl_profile_sampling("m", mlp, "PPO mlp")
    cnn_model = {"fcnet_hiddens": list(RL["hidden"])}
    cnn = _rl_ppo("m", "cnn GridGoal 84x84x1", "GridGoal", {"size": 84},
                  cnn_model, 2,
                  controls=[("conv map flattened NCHW", catalog,
                             "_flatten_nhwc", _nchw_flatten)])
    _rl_profile_sampling("m", cnn, "PPO cnn")
    lstm_model = {"fcnet_hiddens": list(RL["hidden"]), "use_lstm": True,
                  "lstm_cell_size": 64}
    lstm = _rl_ppo("m", "lstm StatelessCartPole", "StatelessCartPole", {},
                   lstm_model, 2,
                   controls=[("no forget-gate bias", catalog, "_lstm_cell",
                              _cell_without_forget_bias)])
    _rl_profile_sampling("m", lstm, "PPO lstm")
    hidden, envs = RL["hidden"], RL["envs"]
    for dueling in (False, True):
        _rl_q("m", f"DQN dueling={dueling}",
              lambda device, d=dueling: dqn.DQNLearner(
                  4, 2, hidden=hidden, lr=RL["lr"], dueling=d, seed=SEED,
                  device=device),
              lambda d=dueling: (dqn.DuelingDQNRunner if d else EnvRunner)(
                  "CartPole-v1", {}, envs, SEED, hidden=hidden))
    _rl_q("m", "C51", lambda device: c51.C51Learner(
              4, 2, hidden=hidden, lr=RL["lr"], seed=SEED, device=device),
          lambda: c51.C51Runner("CartPole-v1", {}, envs, SEED,
                                hidden=hidden))
    _rl_q("m", "QR-DQN", lambda device: qrdqn.QRDQNLearner(
              4, 2, hidden=hidden, lr=RL["lr"], seed=SEED, device=device),
          lambda: qrdqn.QRDQNRunner("CartPole-v1", {}, envs, SEED,
                                    hidden=hidden))
    # The gated update takes one fixed noise draw on both devices.
    probe = noisy.noisy_net_init(SEED, [4, *hidden, 2], device="cpu")
    noise = [noisy.noisy_net_noise(probe["q"], seeded(SEED + i))
             for i in range(3)]
    _rl_q("m", "Noisy DQN", lambda device: noisy.NoisyDQNLearner(
              4, 2, hidden=hidden, lr=RL["lr"], seed=SEED, device=device),
          lambda: noisy.NoisyDQNRunner("CartPole-v1", {}, envs, SEED,
                                       hidden=hidden),
          update_kw=lambda device: {"noise": [
              [tuple(e.to(device) for e in pair) for pair in draw]
              for draw in noise]})
    cue = make_env("MemoryCue", {})
    _rl_q("m", "R2D2 MemoryCue", lambda device: r2d2.R2D2Learner(
              obs_shape_of(cue), cue.num_actions, hidden=hidden,
              lstm_cell_size=RL_Q["r2d2_cell"], lr=RL["lr"], seed=SEED,
              device=device),
          lambda: r2d2.R2D2Runner("MemoryCue", {}, envs, SEED,
                                  hidden=hidden,
                                  lstm_cell_size=RL_Q["r2d2_cell"]),
          sequences=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (n) RLlib's continuous, offline and podracer compute
# ---------------------------------------------------------------------------

# The widths and settings the JAX algorithms configure, cut only in
# iterations: AlgorithmConfig's hidden (64, 64), 2 runners x 1 env, lr 5e-4
# (ray_tpu/rllib/algorithm.py:21-32); SACConfig / TD3Config on
# Pendulum-v1: fragment 64, train batch 256, 500 warm-up steps, one update
# per sampled step, a 100,000-step buffer, PER alpha 0.6 / beta 0.4
# (sac.py:27-44, td3.py:29-40); CQLConfig's 4 OOD actions (cql.py:29-40);
# BC and MARWIL batch 256 (bc.py:23-26, marwil.py:28-34); PodracerConfig's
# 2 gangs x 1 actor x 1 env, fragment 16, hidden (32, 32), minibatch 64
# (ray_tpu/podracer/topology.py:31-56). Five iterations: the buffer passes
# the batch at the second and the warm-up at the fifth, so four update
# (512 updates) and two sample with the policy.
RL_OFF = dict(hidden=(64, 64), runners=2, envs=1, fragment=64, batch=256,
              warmup=500, capacity=100_000, per_alpha=0.6, per_beta=0.4,
              iterations=5, ood=4, offline_updates=200, offline_lr=5e-4,
              cartpole_fragments=3, podracer_ticks=5)
PENDULUM = dict(obs=3, act=1, low=-2.0, high=2.0)


def _rl_first_update(tag, label, learner, make, batch, loss_key, lr,
                     controls=(), noisy=False):
    """The gated first update of a learner of phase (n): the card's against
    a fresh CPU learner's from the same weights on the same batch, with the
    same draws (``noisy``: a CPU learner's own ``draw_noise``, injected on
    both). Each control (label, make or None, (module, name, value) or
    None) must fail the gate. -> (metrics, w0, run, CPU seconds)."""
    w0 = learner.get_weights()
    kw = {}
    if noisy:
        kw["noise"] = {k: v.numpy()
                       for k, v in make("cpu").draw_noise(len(batch)).items()}

    def run(ln):
        return ln.update(batch, **kw)
    metrics = run(learner)
    ref_m, ref_d, cpu_s = _rl_ref(make, w0, run)
    ref = (ref_m, ref_d)
    if not _rl_gate(tag, f"{label}, first update",
                    (metrics, _after(learner, w0, 1)), ref, loss_key, lr=lr,
                    parts=True):
        raise AssertionError(f"{tag}: {label} failed the gate")
    for c_label, c_make, patch in controls:
        with (_patched(*patch) if patch else contextlib.nullcontext()):
            card = _rl_ref(c_make or make, w0, run, device=None)[:2]
        if _rl_gate(tag, f"control, {c_label} (must fail)", card, ref,
                    loss_key, lr=lr, parts=True):
            raise AssertionError(f"{tag}: the control '{c_label}' passed "
                                 "the gate")
    return metrics, w0, run, cpu_s


def _finite(tag, label, metrics) -> None:
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{tag} {label}: metrics {metrics}")


def _rl_continuous(tag, label, make, lr, policy, per=False, controls=(),
                   writer=None):
    """One off-policy algorithm as SAC.training_step / TD3.training_step
    compose it: every runner samples a fragment (uniform actions until the
    warm-up), the batch goes to the replay buffer (and to ``writer``), one
    update per sampled step once the buffer holds a train batch (PER: its
    weights in, |TD| + 1e-6 back as priorities), the actor's weights to
    the runners. -> a runner."""
    from ray_tpu_torch.rllib.env_runner import ContinuousEnvRunner
    from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                                   ReplayBuffer)
    from ray_tpu_torch.rllib.sample_batch import concat_samples
    o = RL_OFF
    learner = make(None)
    runners = [ContinuousEnvRunner("Pendulum-v1", {}, o["envs"],
                                   SEED + 1000 * i, hidden=o["hidden"],
                                   policy=policy)
               for i in range(o["runners"])]
    for r in runners:
        r.set_weights(learner.get_actor_weights())
    buffer = (PrioritizedReplayBuffer(o["capacity"], alpha=o["per_alpha"],
                                      seed=SEED) if per else
              ReplayBuffer(o["capacity"], seed=SEED))
    sampled = updates = 0
    policy_s = []
    for it in range(o["iterations"]):
        t0 = time.perf_counter()
        batch = concat_samples([r.sample_transitions(
            o["fragment"], o["warmup"], sampled) for r in runners])
        if sampled >= o["warmup"]:
            policy_s.append(time.perf_counter() - t0)
        if writer is not None:
            writer.write(batch)
        buffer.add(batch)
        sampled += len(batch)
        metrics = {}
        if len(buffer) >= o["batch"]:
            for _ in range(len(batch)):
                sample = (buffer.sample(o["batch"], beta=o["per_beta"])
                          if per else buffer.sample(o["batch"]))
                if updates == 0:
                    metrics, w0, run, cpu_s = _rl_first_update(
                        tag, label, learner, make, sample, "critic_loss",
                        lr, controls, noisy=True)
                else:
                    metrics = learner.update(sample)
                if per:
                    buffer.update_priorities(sample["batch_indexes"],
                                             learner.last_td_error + 1e-6)
                updates += 1
            _finite(tag, label, metrics)
        for r in runners:
            r.set_weights(learner.get_actor_weights())
        log(f"[{tag}] {label} iteration {it}: {len(batch)} transitions "
            f"({sampled} sampled), buffer {len(buffer)}, {updates} updates"
            + "".join(f", {k} {v:.5f}" for k, v in metrics.items()))
    rewards = [x for r in runners for x in r.episode_rewards()]
    log(f"[{tag}] {label}: {len(rewards)} episodes ended, mean return "
        f"{statistics.mean(rewards):.2f}")
    if updates < 2 * len(batch):
        raise AssertionError(f"{tag} {label}: {updates} updates")
    _rl_report(tag, label, _rl_time_update(make, w0, run), cpu_s,
               statistics.median(policy_s), o["runners"] * o["fragment"],
               o["envs"])
    return runners[0], updates


def _rl_offline(tag, label, make, lr, next_batch, loss_key, controls=(),
                noisy=False):
    """RL_OFF["offline_updates"] updates of an offline learner, each on
    ``next_batch(learner)`` as the algorithm's training_step draws it; the
    first gated. -> the learner."""
    learner = make(None)
    for u in range(RL_OFF["offline_updates"]):
        batch = next_batch(learner)
        if u == 0:
            metrics, w0, run, cpu_s = _rl_first_update(
                tag, label, learner, make, batch, loss_key, lr, controls,
                noisy=noisy)
            first = metrics
        else:
            metrics = learner.update(batch)
    _finite(tag, label, metrics)
    log(f"[{tag}] {label}: {RL_OFF['offline_updates']} updates of "
        f"{len(batch)} rows, {loss_key} {first[loss_key]:.5f} -> "
        f"{metrics[loss_key]:.5f}")
    card_ms = _rl_time_update(make, w0, run)
    log(f"[{tag}] {label}: update {card_ms:.2f} ms on the card (CUDA "
        f"events, median of {RL_TIMED}), {1e3 * cpu_s:.2f} ms on the CPU "
        "(host clock, one update)")
    return learner


def _sac_actor_on_old_critic():
    """Control: SAC's actor loss taken on the critic from before its step."""
    from ray_tpu_torch.rllib.algorithms import sac

    class Control(sac.SACLearner):
        def _critic_loss(self, c, noise):
            self._before = copy.deepcopy(self.module.critic)
            return super()._critic_loss(c, noise)

        def _actor_step(self, c, eps, critic):
            return super()._actor_step(c, eps, self._before)
    return Control


def _marwil_old_norm():
    """Control: MARWIL's weights on the adv_norm from before this step."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.algorithms import marwil
    from ray_tpu_torch.rllib.models import policy_value_apply

    class Control(marwil.MARWILLearner):
        def _loss(self, c):
            logits, values = policy_value_apply(self.module, c[sb.OBS])
            adv = c[marwil.RETURNS] - values
            new_norm = self.adv_norm + self._rate * (
                (adv ** 2).mean().detach() - self.adv_norm)
            w = torch.exp(self._beta * (adv / torch.sqrt(
                self.adv_norm + 1e-8)).detach()).clamp(max=20.0)
            p_loss = -(w * marwil.taken_logp(logits, c[sb.ACTIONS])).mean()
            v_loss = (adv ** 2).mean()
            return p_loss + self._vf_coeff * v_loss, new_norm, p_loss, v_loss
    return Control


def _rl_podracer(tag) -> None:
    """PodracerConfig's members on the card, composed collect -> learn ->
    broadcast for RL_OFF["podracer_ticks"] ticks: versions monotonic,
    applied == tick + 1, the weight tree's bytes and fold time."""
    from ray_tpu_torch.models.convert import flatten
    from ray_tpu_torch.podracer.runtime import (_Learner, _RolloutWorker,
                                                _to_numpy_tree)
    hidden = (32, 32)
    workers = [_RolloutWorker("CartPole-v1", {}, 1, 16, SEED + 1000 * (i + 1),
                              hidden=hidden) for i in range(2)]
    learner = _Learner(4, 2, lr=5e-4, hidden=hidden, minibatch_size=64,
                       num_epochs=1, seed=SEED)
    version, weights = learner.control()
    seen = [[] for _ in workers]
    for tick in range(RL_OFF["podracer_ticks"]):
        batches = [w.collect((tick, version, weights)) for w in workers]
        out = learner.learn(*batches)
        for i, b in enumerate(batches):
            seen[i].append(b["version"])
        if out["applied"] != tick + 1 or out["tick_skew"]:
            raise AssertionError(f"{tag} podracer tick {tick}: {out}")
        _finite(tag, "podracer", out["metrics"])
        if out["weights"] is not None:
            version, weights = out["version"], out["weights"]
    if any(b < a for s in seen for a, b in zip(s, s[1:])) or version != (
            RL_OFF["podracer_ticks"] + 1):
        raise AssertionError(f"{tag} podracer versions {seen}, {version}")
    state = learner._learner.module.state_dict()
    nbytes = sum(v.nbytes for v in flatten(_to_numpy_tree(state)).values())
    times = []
    for _ in range(RL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _to_numpy_tree(state)
        times.append(1e3 * (time.perf_counter() - t0))
    log(f"[{tag}] podracer: {RL_OFF['podracer_ticks']} ticks of 2 members "
        f"-> learner on the card, versions seen {seen}, final version "
        f"{version}, applied == tick + 1; weight tree {nbytes} bytes, "
        f"folded to numpy in {statistics.median(times):.3f} ms (host clock, "
        f"median of {RL_TIMED})")


def phase_offpolicy() -> None:
    """(n) RLlib's continuous, offline and podracer compute on the card:
    SAC, SAC with PER, TD3 and DDPG on Pendulum-v1 through
    ContinuousEnvRunner, a replay buffer and their learners, composed as
    their training_step composes them; CQL on the SAC run's transitions
    written by offline.JsonWriter and read back by JsonReader; BC and
    MARWIL on CartPole fragments of EnvRunner, written and read the same
    way; five podracer ticks. Each first update gated against the CPU's
    (TF32 off), each control failing it; update times, time per env step
    of ContinuousEnvRunner, and its sampling under torch.profiler."""
    import tempfile

    import numpy as np
    t_start = time.perf_counter()
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.algorithms import bc, cql, marwil, sac, td3
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[n] torch.backends.cuda.matmul.allow_tf32 = False, "
        "cudnn.allow_tf32 = False")
    o, p = RL_OFF, PENDULUM
    dims = (p["obs"], p["act"], p["low"], p["high"])

    def sac_make(cls=sac.SACLearner, **kw):
        return lambda device: cls(*dims, hidden=o["hidden"], seed=SEED,
                                  device=device, **kw)

    def td3_make(**kw):
        return lambda device: td3.TD3Learner(*dims, hidden=o["hidden"],
                                             seed=SEED, device=device, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        writer = JsonWriter(os.path.join(tmp, "pendulum"))
        runner, total = _rl_continuous(
            "n", "SAC Pendulum-v1", sac_make(), 3e-4, "squashed_gaussian",
            writer=writer,
            controls=[("actor loss on the critic before its step",
                       sac_make(_sac_actor_on_old_critic()), None)])
        writer.close()
        _rl_profile_sampling(
            "n", runner, "ContinuousEnvRunner (SAC)", closing=0,
            sample=lambda n: runner.sample_transitions(n))
        total += _rl_continuous("n", "SAC+PER Pendulum-v1", sac_make(),
                                3e-4, "squashed_gaussian", per=True)[1]
        total += _rl_continuous(
            "n", "TD3 Pendulum-v1", td3_make(), 1e-3, "deterministic",
            controls=[("actor stepped every update",
                       td3_make(policy_delay=1), None)])[1]
        total += _rl_continuous("n", "DDPG Pendulum-v1",
                                td3_make(**td3.DDPG_DEFAULTS), 1e-3,
                                "deterministic")[1]
        log(f"[n] off-policy: {total} gradient steps in all")

        data = JsonReader(os.path.join(tmp, "pendulum"), seed=SEED).read_all()
        rows = np.random.RandomState(SEED)

        def cql_batch(_learner):
            idx = rows.randint(0, len(data), size=min(o["batch"], len(data)))
            return sb.SampleBatch({k: v[idx] for k, v in data.items()})
        _rl_offline(
            "n", f"CQL on {len(data)} Pendulum transitions (JsonReader)",
            sac_make(cql.CQLLearner, num_ood_actions=o["ood"]), 3e-4,
            cql_batch, "critic_loss", noisy=True,
            controls=[("logsumexp over the batch axis", None,
                       (cql, "_sample_lse", lambda q: torch.logsumexp(
                           q, dim=1, keepdim=True)))])

        writer = JsonWriter(os.path.join(tmp, "cartpole"))
        for i in range(o["runners"]):
            r = EnvRunner("CartPole-v1", {}, o["envs"], SEED + 1000 * i,
                          hidden=o["hidden"])
            for _ in range(o["cartpole_fragments"]):
                writer.write(r.sample(RL["fragment"]))
        writer.close()
        path = os.path.join(tmp, "cartpole")
        data = JsonReader(path, seed=SEED).read_all()
        frags = []
        for frag in JsonReader(path, seed=SEED).iter_batches():
            frag[marwil.RETURNS] = marwil._returns_to_go(frag, 0.99)
            frags.append(frag)
        returns = sb.concat_samples(frags)

    def offline_make(cls, **kw):
        return lambda device: cls(4, 2, hidden=o["hidden"],
                                  lr=o["offline_lr"], seed=SEED,
                                  device=device, **kw)
    bc_learner = _rl_offline(
        "n", f"BC on {len(data)} CartPole steps (JsonReader)",
        offline_make(bc.BCLearner), o["offline_lr"],
        lambda ln: ln.sample(data, o["batch"]), "loss")
    marwil_learner = _rl_offline(
        "n", f"MARWIL on {len(returns)} CartPole steps",
        offline_make(marwil.MARWILLearner), o["offline_lr"],
        lambda ln: ln.sample(returns, o["batch"]), "loss",
        controls=[("weights on the old adv_norm",
                   offline_make(_marwil_old_norm()), None)])
    for name, ln in (("BC", bc_learner), ("MARWIL", marwil_learner)):
        out = bc.evaluate(ln.module, "CartPole-v1", {}, SEED, num_episodes=1)
        log(f"[n] {name} evaluate: greedy return "
            f"{out['evaluation_reward_mean']:.1f} (1 episode)")
    _rl_podracer("n")
    torch.cuda.empty_cache()
    log(f"[n] phase (n) took {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# (o) RLlib's algorithms through their own entry points
# ---------------------------------------------------------------------------

# Every algorithm of ray_tpu_torch.rllib at its JAX config's defaults:
# AlgorithmConfig's hidden (64, 64), 2 runners x 1 env, lr 5e-4
# (ray_tpu/rllib/algorithm.py:21-32) and each config's own fragment,
# minibatch, epochs, buffer and learning_starts (APEX's 4 runners). Cut
# only in iterations: the on-policy, continuous, offline and ES algorithms
# take 3; DQN, C51, QR-DQN and Noisy DQN (64 steps an iteration, learning
# from 500 stored) 9; R2D2 (32 steps an iteration) 17; APEX (128) 6. Each
# off-policy algorithm so updates in its last two iterations.
ALGO_ITERS = dict(on=3, q=9, r2d2=17, apex=6)
# The gate (TF32 off): the card's run against a CPU run of the same
# config from the same weights (a fresh card algorithm's checkpoint):
#   - every sampled batch identical (actions, rewards, terminations) up to
#     and including the iteration after the first update;
#   - the first updating iteration's loss within ALGO_LOSS_RTOL, relative;
#   - after every iteration each runner holds the learner's weights.
# The SAC family's updates take the CPU run's draws (``noise=``); Noisy DQN
# draws in its runners and updates on the device, so its gate holds the
# step counts, replay size, updates and target syncs instead of the batch
# and the loss. Controls that must fail it: PPO and DQN with the broadcast
# after their updates skipped.
ALGO_LOSS_RTOL = 1e-4
CARD = None        # the device phase (o) leaves to its default: the card
_SAMPLERS = ("sample", "sample_transitions", "sample_sequences",
             "evaluate_perturbations")


def _algo_configs(data) -> list:
    """(label, config factory, iterations, loss key, draws): draws "update"
    (the SAC family: the card's updates take the CPU run's draws),
    "device" (Noisy DQN: runners and updates draw on the device) or
    None."""
    from ray_tpu_torch import rllib as R
    it = ALGO_ITERS

    def two_policies():
        return R.PPOConfig().environment("MultiCartPole").multi_agent(
            policies=["p0", "p1"], policy_mapping_fn=_policy_of)

    return [
        ("PPO", R.PPOConfig, it["on"], "total_loss", None),
        ("PPO multi-agent", two_policies, it["on"], "p0/total_loss", None),
        ("A2C", R.A2CConfig, it["on"], "total_loss", None),
        ("PG", R.PGConfig, it["on"], "total_loss", None),
        ("IMPALA", R.ImpalaConfig, it["on"], "total_loss", None),
        ("APPO", R.APPOConfig, it["on"], "total_loss", None),
        ("DQN", R.DQNConfig, it["q"], "loss", None),
        ("C51", R.C51Config, it["q"], "loss", None),
        ("QR-DQN", R.QRDQNConfig, it["q"], "loss", None),
        ("Noisy DQN", R.NoisyDQNConfig, it["q"], None, "device"),
        ("R2D2", lambda: R.R2D2Config().environment("MemoryCue"),
         it["r2d2"], "loss", None),
        ("APEX-DQN", R.ApexDQNConfig, it["apex"], "loss", None),
        ("SAC", R.SACConfig, it["on"], "critic_loss", "update"),
        ("TD3", R.TD3Config, it["on"], "critic_loss", "update"),
        ("DDPG", R.DDPGConfig, it["on"], "critic_loss", "update"),
        ("CQL", lambda: R.CQLConfig().offline_data(
            input_path=data["pendulum"]), it["on"], "critic_loss", "update"),
        ("BC", lambda: R.BCConfig().offline_data(
            input_path=data["cartpole"]), it["on"], "loss", None),
        ("MARWIL", lambda: R.MARWILConfig().offline_data(
            input_path=data["cartpole"]), it["on"], "loss", None),
        ("ES", R.ESConfig, it["on"], "theta_norm", None),
        ("ARS", R.ARSConfig, it["on"], "theta_norm", None),
    ]


def _policy_of(agent: str) -> str:
    return f"p{agent[-1]}"


def _algo_learners(algo) -> list:
    if getattr(algo, "learners", None):
        return list(algo.learners.values())
    return [algo.learner] if hasattr(algo, "learner") else []


def _algo_record(algo, draws=None, replay=False) -> dict:
    """Wrap the in-process runners' samplers to keep what they return, and
    the learners' updates to count them (and to record or replay the SAC
    family's draws: ``draws`` is recorded into, or with ``replay`` taken
    from, in order)."""
    rec = {"samples": [], "updates": 0, "syncs": 0}
    for handle in algo.env_runners:
        runner = handle._obj
        for name in _SAMPLERS:
            if hasattr(runner, name):
                fn = getattr(runner, name)

                def kept(*a, _fn=fn, **kw):
                    out = _fn(*a, **kw)
                    rec["samples"].append(out)
                    return out
                setattr(runner, name, kept)
    for ln in _algo_learners(algo):
        update = ln.update

        def counted(batch, *a, _ln=ln, _update=update, **kw):
            rec["updates"] += 1
            if not algo.env_runners:        # offline: the rows drawn
                rec["samples"].append(batch)
            if draws is not None:
                if replay:
                    kw["noise"] = draws.pop(0)
                else:
                    kw["noise"] = _ln.draw_noise(len(batch))
                    draws.append(kw["noise"])
            return _update(batch, *a, **kw)
        ln.update = counted
        if hasattr(ln, "sync_target"):
            sync = ln.sync_target

            def synced(_sync=sync):
                rec["syncs"] += 1
                return _sync()
            ln.sync_target = synced
    return rec


def _same_samples(a, b) -> bool:
    import numpy as np
    from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch
    if isinstance(a, MultiAgentBatch):
        pa, pb = a.policy_batches, b.policy_batches
        return sorted(pa) == sorted(pb) and all(
            _same_samples(pa[k], pb[k]) for k in pa)
    if isinstance(a, dict):
        keys = [k for k in ("actions", "rewards", "terminateds",
                            "truncateds", "dones") if k in a]
        return bool(keys) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
            for k in keys)
    return np.array_equal(np.asarray(a, np.float64),
                          np.asarray(b, np.float64))


def _runners_synced(algo) -> bool:
    """Each in-process runner holds the weights the learners last handed
    it (what broadcast_weights sends)."""
    if not _algo_learners(algo) or not algo.env_runners:
        return True
    for handle in algo.env_runners:
        runner = handle._obj
        if getattr(algo, "learners", None):
            pairs = [(runner.modules[pid], ln.get_weights())
                     for pid, ln in algo.learners.items()]
        elif hasattr(algo.learner, "get_actor_weights"):
            pairs = [(runner.module, algo.learner.get_actor_weights())]
        else:
            pairs = [(runner.module, algo.learner.get_weights())]
        for module, want in pairs:
            for k, v in module.state_dict().items():
                if not torch.equal(v, want[k].to(v.device)):
                    return False
    return True


def _algo_state(algo) -> dict:
    """Every array a checkpoint restores, on the host, by name."""
    import numpy as np
    out = {}
    learners = (getattr(algo, "learners", None)
                or {"": getattr(algo, "learner", None)})
    for pid, ln in learners.items():
        if ln is None:
            continue
        for k, v in ln.get_weights().items():
            out[f"{pid}/{k}"] = v.cpu()
        if hasattr(ln, "get_target_weights"):
            for k, v in ln.get_target_weights().items():
                out[f"{pid}/target.{k}"] = v.cpu()
        if hasattr(ln, "adv_norm"):
            out[f"{pid}/adv_norm"] = ln.adv_norm.cpu()
    for k in ("theta", "_m", "_v"):
        if hasattr(algo, k):
            out[k] = torch.from_numpy(np.asarray(getattr(algo, k)))
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if torch.is_tensor(tree) else tree


def _algo_run(make, iters, device, ckpt=None, draws=None, replay=False,
              skip_broadcast=False):
    """Build from the config, load ``ckpt`` (before anything samples, as
    IMPALA primes its rollouts in setup), train ``iters`` iterations. ->
    (algo, results, host ms per iteration, per-iteration record)."""
    cfg = make()
    cfg.resources(device=device)
    if ckpt is not None:
        base = cfg.algo_class

        class Loaded(base):
            def build_learner(self):
                super().build_learner()
                self.load_checkpoint(ckpt)
        cfg.algo_class = Loaded
    algo = cfg.build()
    if skip_broadcast:
        algo.broadcast_weights = lambda params: None
    rec = _algo_record(algo, draws, replay)
    results, ms, per_iter = [], [], []
    for _ in range(iters):
        rec.update(samples=[], updates=0, syncs=0)
        t0 = time.perf_counter()
        results.append(algo.train())
        if device != "cpu":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        per_iter.append(dict(samples=rec["samples"],
                             updates=rec["updates"], syncs=rec["syncs"],
                             synced=_runners_synced(algo)))
    return algo, results, ms, per_iter


def _algo_gate(card, ref, loss_key, draws) -> tuple:
    """-> (passed, the reading). ``card`` and ``ref``: _algo_run's
    (results, per-iteration records)."""
    (rc, ic), (rr, ir) = card, ref
    first = next((i for i, r in enumerate(rr)
                  if loss_key is not None and loss_key in r), None)
    upto = len(rr) if first is None else min(len(rr), first + 2)
    counts = ["num_env_steps_sampled", "replay_size", "replay_sequences",
              "buffer_size", "num_samples_trained"]
    if draws != "device":
        counts.append("episodes_total")
    same_counts = all(rc[i].get(k) == rr[i].get(k) and
                      ic[i]["updates"] == ir[i]["updates"] and
                      ic[i]["syncs"] == ir[i]["syncs"]
                      for i in range(len(rr)) for k in counts)
    same_batches = draws == "device" or all(
        len(ic[i]["samples"]) == len(ir[i]["samples"]) and all(
            _same_samples(a, b) for a, b in zip(ic[i]["samples"],
                                                ir[i]["samples"]))
        for i in range(upto))
    synced = all(r["synced"] for r in ic)
    reading = (("batches not compared (drawn on the device)"
                if draws == "device" else
                f"batches identical through iteration {upto}: "
                f"{same_batches}") + f"; counts, updates and target syncs "
               f"equal: {same_counts}; runners hold the learner's weights: "
               f"{synced}; ")
    loss_ok = True
    if first is None:
        reading += "no loss"
    else:
        lc, lr_ = float(rc[first][loss_key]), float(rr[first][loss_key])
        loss_rel = abs(lc - lr_) / max(abs(lr_), 1e-30)
        loss_ok = math.isfinite(lc) and loss_rel <= ALGO_LOSS_RTOL
        reading += (f"{loss_key} at iteration {first + 1} {lc:.6g} against "
                    f"the CPU's {lr_:.6g}, rel {loss_rel:.2e} (tol "
                    f"{ALGO_LOSS_RTOL:.0e})")
    return same_counts and same_batches and synced and loss_ok, reading


def _algo_data(tmp) -> dict:
    """The offline algorithms' input, made on the CPU: 1200 CartPole steps
    of two EnvRunners (3 fragments of 200 each) and 1200 Pendulum
    transitions of two ContinuousEnvRunners acting at random, written by
    JsonWriter."""
    from ray_tpu_torch.rllib.env_runner import ContinuousEnvRunner, EnvRunner
    from ray_tpu_torch.rllib.offline import JsonWriter
    out = {}
    for name, make, sample in (
            ("cartpole", lambda i: EnvRunner(
                "CartPole-v1", {}, 1, SEED + 1000 * i, device="cpu"),
             lambda r: r.sample(200)),
            ("pendulum", lambda i: ContinuousEnvRunner(
                "Pendulum-v1", {}, 1, SEED + 1000 * i, device="cpu"),
             lambda r: r.sample_transitions(200, random_until=10 ** 9))):
        out[name] = os.path.join(tmp, name)
        writer = JsonWriter(out[name])
        for i in range(2):
            runner = make(i)
            for _ in range(3):
                writer.write(sample(runner))
        writer.close()
    return out


def phase_algorithms() -> dict:
    """(o) Every algorithm of ray_tpu_torch.rllib built from its config and
    trained through ``build().train()``, the learners and runners on the
    card (device left to its default) and the runners behind the
    in-process runtime (``local_runtime``), at the JAX configs' default
    widths cut in iterations (ALGO_ITERS). Each is gated against a CPU run
    of the same config from the same weights (ALGO_LOSS_RTOL and the
    checks above it); PPO and DQN with their post-update broadcast skipped
    must fail the gate; a save_checkpoint loaded into a fresh algorithm on
    the card restores every array bit for bit. Printed per algorithm:
    iteration ms on the card and on the CPU (host clock, median after the
    first), env steps and updates per iteration; for PPO and DQN one more
    iteration under torch.profiler (copies and syncs). This phase does not
    import ray_tpu: the injected runtime (``build(runtime=ray_tpu)``) is
    exercised by the CPU tests alone. -> {label: iteration ms on the
    card}."""
    import tempfile
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[o] torch.backends.cuda.matmul.allow_tf32 = False, "
        "cudnn.allow_tf32 = False")
    with tempfile.TemporaryDirectory() as tmp:
        configs = _algo_configs(_algo_data(tmp))
        card_ms = {label: _algo_one(label, make, iters, loss_key, draws)
                   for label, make, iters, loss_key, draws in configs}
    torch.cuda.empty_cache()
    log(f"[o] phase (o) took {time.perf_counter() - t_start:.1f} s")
    return card_ms


def _algo_one(label, make, iters, loss_key, draws) -> float:
    # The weights both runs start from: a fresh card algorithm's.
    first = _algo_run(make, 0, CARD)[0]
    ckpt = first.save_checkpoint()
    first.stop()
    shared = [] if draws == "update" else None
    cpu_algo, rr, cpu_ms, ir = _algo_run(make, iters, "cpu",
                                         _to_cpu(ckpt), shared)
    cpu_algo.stop()
    algo, rc, card_ms, ic = _algo_run(make, iters, CARD, ckpt, shared,
                                      replay=True)
    ok, reading = _algo_gate((rc, ic), (rr, ir), loss_key, draws)
    log(f"[o] gate {label}: {reading}: {'pass' if ok else 'fail'}")
    if not ok:
        raise AssertionError(f"{label} failed the gate")
    if label in ("PPO", "DQN"):
        c_algo, c_res, _, c_rec = _algo_run(make, iters, CARD, ckpt,
                                            skip_broadcast=True)
        c_algo.stop()
        c_ok, c_reading = _algo_gate((c_res, c_rec), (rr, ir), loss_key,
                                     draws)
        log(f"[o] gate {label}, control, broadcast after the update "
            f"skipped (must fail): {c_reading}: "
            f"{'pass' if c_ok else 'fail'}")
        if c_ok:
            raise AssertionError(f"{label}: the control passed the gate")
    steps = [r.get("num_env_steps_sampled", r.get("num_samples_trained"))
             for r in rc]
    if label in ("SAC", "TD3", "DDPG"):       # lifetime counts
        steps = [b - a for a, b in zip([0] + steps, steps)]
    minib = [r.get("num_minibatch_updates", r.get("p0/num_minibatch_updates"))
             for r in rc]
    log(f"[o] {label}: iteration {statistics.median(card_ms[1:]):.1f} ms on "
        f"the card, {statistics.median(cpu_ms[1:]):.1f} ms on the CPU (host "
        f"clock, median of iterations 2-{iters}); "
        + (f"{'env steps' if algo.env_runners else 'rows'} per "
           f"iteration {steps}; " if steps[0] is not None
           else "greedy evaluation episodes only; ")
        + f"learner updates per iteration {[i['updates'] for i in ic]}"
        + (f" (minibatch steps {minib})" if minib[0] is not None else "")
        + f"; last {_algo_summary(rc[-1])}")
    fresh = _algo_run(lambda: make().debugging(seed=SEED + 1), 0, CARD)[0]
    fresh.load_checkpoint(algo.save_checkpoint())
    want, got = _algo_state(algo), _algo_state(fresh)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    log(f"[o] {label} checkpoint: {len(want)} arrays restored into a fresh "
        f"algorithm on the card, differing: {differ or 'none'}")
    if sorted(want) != sorted(got) or differ or not want:
        raise AssertionError(f"{label}: checkpoint round trip differs")
    fresh.stop()
    if label in ("PPO", "DQN"):
        d2h, h2d, kernels, copies, syncs, dev_ms, host_ms = _profile_counts(
            algo.train)
        log(f"[o] {label} one iteration under torch.profiler: {d2h} "
            f"device-to-host and {h2d} host-to-device copies ({copies} "
            f"cudaMemcpy(Async) calls), {syncs} stream syncs, {kernels} "
            f"kernels, device {dev_ms:.2f} ms of {host_ms:.1f} ms on the host "
            f"clock (the card idle {100 * (1 - dev_ms / host_ms):.1f}% of it)")
    algo.stop()
    return statistics.median(card_ms[1:])


def _algo_summary(result) -> str:
    keys = [k for k in ("total_loss", "loss", "critic_loss", "theta_norm",
                        "episode_reward_mean") if k in result]
    return ", ".join(f"{k} {float(result[k]):.4g}" for k in keys)


# ---------------------------------------------------------------------------
# (p) the main path through the Train harness
# ---------------------------------------------------------------------------

# Phase (p)'s loop: GPT-2 small at (e)'s batch, sequence and optimizer, a
# checkpoint after every second step; run A raises before step 5 in its
# first attempt and resumes from the checkpoint after step 3.
HARNESS = dict(steps=8, every=2, fail_at=5, fail_rank=0,
               batch=MAIN["batch"], seq=MAIN["seq"], cfg={},
               mesh={"data": 1}, strategy="dp", device=None, control=None)
HARNESS_REPORTS = 200    # reports of an empty loop: the cost of one report


def harness_batch(vocab, batch, seq, k, device):
    """The batch of step k: tokens drawn from (SEED, k) alone, so that a
    resumed run trains on the batches the uninterrupted one did."""
    import numpy as np
    toks = np.random.default_rng([SEED, k]).integers(0, vocab,
                                                     (batch, seq + 1))
    return {"tokens": torch.from_numpy(toks).to(device)}


def _harness_log(out, rank, **event) -> None:
    with open(os.path.join(out, f"rank{rank}.jsonl"), "a") as f:
        f.write(json.dumps(event) + "\n")


def harness_events(out, rank=0) -> list:
    with open(os.path.join(out, f"rank{rank}.jsonl")) as f:
        return [json.loads(line) for line in f]


def harness_loop(config):
    """A worker's train loop under the port's Trainer (phase (p); the
    four-card test of tests/test_torch_cuda.py runs it too): GPT-2 small
    (``config["cfg"]`` overrides fields) through build_mesh(MeshConfig(
    **config["mesh"])) -> init_train_state(..., config["strategy"]) ->
    make_train_step, AdamW(3e-4), on ``config["device"]`` (None: the
    card). It resumes from get_checkpoint() where there is one, restoring
    the whole TrainState (params, Adam's moments and count, step), and runs
    to ``config["steps"]``; the batch of step k is harness_batch's. After
    every ``config["every"]``-th step every rank writes its shards
    (save_pytree) to one directory of this attempt and reports it as the
    checkpoint; other steps report without one. In its first attempt rank
    ``config["fail_rank"]`` raises before step ``config["fail_at"]``
    (None: never; a marker file beside the log says the raise happened).
    Each rank appends its events (start, step, save, load, raise, end:
    pid, card, card UUID, per step loss, grad norm, host-clock ms and
    K1-K3 launches, save and load ms and bytes, memory) to
    ``config["out"]``/rank<r>.jsonl, and the final TrainState to
    ``config["out"]``/final. Controls (``config["control"]``):
    "reset_moments" restores the params but resets Adam's moments and
    count; "off_by_one" resumes one step early, training the last
    checkpointed step's batch again."""
    from ray_tpu_torch import resolve_device, train
    from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss
    from ray_tpu_torch.ops.attention import KERNELS
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.train import (Checkpoint, adamw, init_train_state,
                                     load_pytree, make_train_step,
                                     save_pytree)
    from ray_tpu_torch.train.train_step import AdamWState, TrainState
    ctx = train.get_context()
    rank, world, out = ctx.get_world_rank(), ctx.get_world_size(), \
        config["out"]
    dev = resolve_device(config["device"])
    cuda = dev.type == "cuda"
    log_path = os.path.join(out, f"rank{rank}.jsonl")
    attempt = 1 + (sum(e["event"] == "start" for e in harness_events(
        out, rank)) if os.path.exists(log_path) else 0)
    card = torch.cuda.current_device() if cuda else -1
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _harness_log(out, rank, event="start", attempt=attempt, pid=os.getpid(),
                 card=card, uuid=str(getattr(torch.cuda.get_device_properties(
                     card), "uuid", "")) if cuda else "",
                 allocated_gb=torch.cuda.memory_allocated() / 1e9
                 if cuda else 0.0, t=time.time())

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), **config["cfg"])
    mesh = build_mesh(MeshConfig(**config["mesh"]),
                      devices=None if cuda else ["cpu"] * world)
    opt = adamw(3e-4)
    state = init_train_state(lambda: gpt_init(cfg, device=dev), opt, mesh,
                             config["strategy"])
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = load_pytree(ckpt.path, state=state)
        if cuda:
            torch.cuda.synchronize()
        _harness_log(out, rank, event="load", step=state.step,
                     ms=1e3 * (time.perf_counter() - t0),
                     bytes=_dir_bytes(ckpt.path))
        start = state.step
        if config["control"] == "reset_moments":
            o = state.opt_state
            for t in o.mu + o.nu:
                t.zero_()
            state = TrainState(state.params, AdamWState(o.mu, o.nu, 0),
                               state.step)
        elif config["control"] == "off_by_one":
            start -= 1
    step = make_train_step(gpt_loss, opt, mesh, config["strategy"])
    for k in range(start, config["steps"]):
        if (k == config["fail_at"] and rank == config["fail_rank"]
                and not os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            _harness_log(out, rank, event="raise", step=k, t=time.time(),
                         peak_gb=peak())
            raise RuntimeError(f"rank {rank}: injected failure before step "
                               f"{k}")
        batch = harness_batch(cfg.vocab_size, config["batch"],
                              config["seq"], k, dev)
        before = {n: kern.launches for n, kern in KERNELS.items()}
        if cuda:
            torch.cuda.synchronize()
        t_wall, t0 = time.time(), time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])    # host readback ends the step
        if cuda:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {n: kern.launches - before[n]
                    for n, kern in KERNELS.items()}
        _harness_log(out, rank, event="step", attempt=attempt, step=k,
                     loss=loss, grad_norm=float(m["grad_norm"]), ms=ms,
                     t=t_wall, launches=launches)
        metrics = {"step": k, "loss": loss}
        if (k + 1) % config["every"]:
            train.report(metrics)
            continue
        d = os.path.join(ctx.get_storage_path(), ctx.get_experiment_name(),
                         f"checkpoint_{k:06d}_{ctx.get_trial_id()}")
        t0 = time.perf_counter()
        save_pytree(state, d)
        _harness_log(out, rank, event="save", step=k,
                     ms=1e3 * (time.perf_counter() - t0),
                     bytes=_dir_bytes(d))
        train.report(metrics, checkpoint=Checkpoint.from_directory(d))
    _harness_log(out, rank, event="end", attempt=attempt, peak_gb=peak())
    # The final state, for the gate: retention may have evicted the last
    # step's checkpoint.
    save_pytree(state, os.path.join(out, "final"))


def _dir_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _report_loop(config):
    """An empty loop that reports ``config["n"]`` times: the harness's own
    cost per report (the driver's poll round trip and bookkeeping)."""
    from ray_tpu_torch import train
    t0 = time.perf_counter()
    for i in range(config["n"]):
        train.report({"i": i})
    _harness_log(config["out"], 0, event="reports", n=config["n"],
                 ms=1e3 * (time.perf_counter() - t0) / config["n"])


def harness_fit(root, name, loop=harness_loop, workers=1, failures=0,
                resume=None, runtime=None, backend=None, **config):
    """``loop`` through the port's Trainer: ``workers`` workers, one card
    each (use_gpu unless the backend's platform is "cpu"), top-2
    checkpoints by the lowest loss, ``failures`` retries, HARNESS's loop
    config updated by ``config``; the run's directory is root/name. ->
    (Result, the run's directory)."""
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, Trainer)
    out = os.path.join(root, name)
    os.makedirs(out)
    config = dict(HARNESS, out=out, marker=os.path.join(out, "fail_once"),
                  **config)
    cpu = backend is not None and backend.platform == "cpu"
    result = Trainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=not cpu),
        run_config=RunConfig(
            name=name, storage_path=root,
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="loss",
                checkpoint_score_order="min"),
            failure_config=FailureConfig(max_failures=failures)),
        backend_config=backend, resume_from_checkpoint=resume,
        runtime=runtime).fit()
    return result, out


def _flat(tree, prefix="") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def harness_gate(run_dir, ref_dir, ref_state=None) -> tuple:
    """-> (equal, reading, the reference's (loss, state)): a run's final
    loss and final TrainState (every leaf: params, Adam's moments and
    count, step) against the reference run's, bit for bit; both runs'
    directories. A run whose final loss differs fails without its state
    being read."""
    from ray_tpu_torch.train import load_pytree

    def loss(d):
        return [e["loss"] for e in harness_events(d)
                if e["event"] == "step"][-1]

    def state(d):
        return _flat(load_pytree(os.path.join(d, "final")))
    la = loss(run_dir)
    lb, b = ref_state or (loss(ref_dir), state(ref_dir))
    reading = f"final loss {la!r} against {lb!r}"
    if la != lb:
        return False, reading + " (states not read)", (lb, b)
    a = state(run_dir)
    differ = sorted(set(a) ^ set(b)) + [p for p in a if p in b and not (
        torch.equal(a[p], b[p]) if isinstance(a[p], torch.Tensor)
        else a[p] == b[p])]
    return not differ, (reading + f"; {len(differ)} of {len(b)} TrainState "
                        f"leaves differ" + (
                            f" ({', '.join(differ[:3])}"
                            f"{', ...' if len(differ) > 3 else ''})"
                            if differ else "")), (lb, b)


def phase_harness(e_step_ms) -> None:
    """(p) the main path through the port's Train harness:
    Trainer(harness_loop, ScalingConfig(num_workers=1, use_gpu=True),
    CheckpointConfig(num_to_keep=2, score "loss", "min"), ...).fit() with no
    runtime (a gang of one in this process, the loop on the worker's
    train_loop thread) and the device left to its default (the card).
    Run B trains HARNESS["steps"] steps uninterrupted; run A (the main
    path: every kernel count set to 0 just before it and read just after)
    raises before step 5 in its first attempt and, under
    FailureConfig(max_failures=1), resumes from the checkpoint after step
    3. Gate: A's final loss and final TrainState equal B's bit for bit;
    24/12/12 launches of K1-K3 in every step of both attempts; exactly
    two checkpoint directories left, those of the two lowest losses, with
    Result.checkpoint the lower; Result.error None and two attempts.
    Controls that must fail the gate, each resumed through the harness from
    the earlier of A's two kept checkpoints (after step 5 where the loss
    falls): Adam's moments and count reset, and the step counter one step
    early. Printed: step ms in the harness beside
    (e)'s, the harness's cost per report, save_pytree and load_pytree ms
    and bytes, the restart time (from the raise to the first step of the
    second attempt) and each attempt's peak device memory. This phase does
    not import ray_tpu: the gang of ray_tpu actors across cards runs in
    tests/test_torch_cuda.py (test_trainer_gang_across_cards_matches_one_card)."""
    import shutil
    import tempfile

    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.ops.attention import KERNELS
    t_start = time.perf_counter()
    n = HARNESS["steps"]
    root = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    try:
        rep, rep_dir = harness_fit(root, "reports", loop=_report_loop,
                                   n=HARNESS_REPORTS)
        per_report = harness_events(rep_dir)[-1]["ms"]
        if len(rep.metrics_dataframe) != HARNESS_REPORTS:
            raise AssertionError(f"{len(rep.metrics_dataframe)} reports "
                                 f"reached the driver of {HARNESS_REPORTS}")
        ref, ref_dir = harness_fit(root, "B", fail_at=None)
        torch.cuda.empty_cache()
        for kern in KERNELS.values():
            kern.launches = 0
        run, run_dir = harness_fit(root, "A", failures=1)
        launches = {k: kern.launches for k, kern in KERNELS.items()}
        torch.cuda.empty_cache()
        # The controls resume from the earlier kept checkpoint (at most
        # step 5, so that each trains two steps or more).
        mid, mid_m = min(run.best_checkpoints, key=lambda cm: cm[1]["step"])
        ok, reading, ref_state = harness_gate(run_dir, ref_dir)
        c_gates = {}
        for control in ("reset_moments", "off_by_one"):
            c_dir = harness_fit(root, control, fail_at=None, resume=mid,
                                control=control, every=n + 1)[1]
            torch.cuda.empty_cache()
            c_gates[control] = harness_gate(c_dir, ref_dir, ref_state)[:2]
        del ref_state
        events = harness_events(run_dir)
        ref_events = harness_events(ref_dir)
        kept = sorted(d for d in os.listdir(run_dir)
                      if d.startswith("checkpoint_"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    steps = [e for e in events if e["event"] == "step"]
    ref_steps = [e for e in ref_events if e["event"] == "step"]
    starts = [e for e in events if e["event"] == "start"]
    raised = next(e for e in events if e["event"] == "raise")
    ends = [e for e in events if e["event"] == "end"]
    saves = [e for e in events + ref_events if e["event"] == "save"]
    loads = [e for e in events if e["event"] == "load"]
    first2 = next(e for e in steps if e["attempt"] == 2)
    for e in steps:
        log(f"[p] A attempt {e['attempt']} step {e['step']}: loss "
            f"{e['loss']:.5f} grad_norm {e['grad_norm']:.5f} {e['ms']:.1f} ms "
            f"launches {e['launches']}")
    for e in ref_steps:
        log(f"[p] B step {e['step']}: loss {e['loss']:.5f} grad_norm "
            f"{e['grad_norm']:.5f} {e['ms']:.1f} ms")
    ms_a = [e["ms"] for e in steps]
    ms_b = [e["ms"] for e in ref_steps]
    log(f"[p] step in the harness: B {statistics.median(ms_b[1:]):.1f} ms, A "
        f"{statistics.median(ms_a[1:]):.1f} ms (host clock, median after the "
        f"first), beside (e)'s {e_step_ms:.1f} ms")
    log(f"[p] harness cost per report: {per_report:.3f} ms "
        f"({HARNESS_REPORTS} reports of an empty loop, in process)")
    log(f"[p] save_pytree: {statistics.median(e['ms'] for e in saves):.0f} ms "
        f"median of {len(saves)} ({min(e['ms'] for e in saves):.0f}-"
        f"{max(e['ms'] for e in saves):.0f}), {saves[0]['bytes'] / 1e9:.2f} "
        f"GB; load_pytree: {loads[0]['ms']:.0f} ms, "
        f"{loads[0]['bytes'] / 1e9:.2f} GB (step {loads[0]['step']})")
    log(f"[p] restart: {first2['t'] - raised['t']:.2f} s from the raise "
        f"before step {raised['step']} to the first step of attempt 2 (step "
        f"{first2['step']})")
    log(f"[p] peak device memory: attempt 1 {raised['peak_gb']:.2f} GB; "
        f"attempt 2 {ends[-1]['peak_gb']:.2f} GB, "
        f"{starts[-1]['allocated_gb']:.3f} GB allocated at its start "
        f"(attempt 1 at its start: {starts[0]['allocated_gb']:.3f} GB)")
    log(f"[p] launches over run A ({len(steps)} steps in 2 attempts): "
        f"{launches}")
    ckpt_losses = sorted((m["loss"], m["step"]) for _, m in
                         run.best_checkpoints)
    reported = sorted((r["loss"], r["step"]) for r in run.metrics_dataframe
                      if (r["step"] + 1) % HARNESS["every"] == 0)
    log(f"[p] A: error {run.error}, {len(starts)} attempts, "
        f"{len(run.metrics_dataframe)} reports; checkpoints left {kept}, "
        f"kept (loss, step) {ckpt_losses} of those reported {reported}, "
        f"Result.checkpoint {os.path.basename(run.checkpoint.path)}")
    log(f"[p] gate A vs B: {reading}: {'pass' if ok else 'fail'}")
    for c, (c_ok, c_reading) in c_gates.items():
        log(f"[p] gate, control ({c}, resumed from A's checkpoint after step "
            f"{mid_m['step']}) vs B (must fail): {c_reading}: "
            f"{'pass' if c_ok else 'fail'}")

    want = _expected_launches(dataclasses.replace(GPTConfig.gpt2_small(),
                                                  **HARNESS["cfg"]))
    bad = [e["step"] for e in steps + ref_steps if e["launches"] != want]
    if bad:
        raise AssertionError(f"harness steps {bad}: launches differ from "
                             f"{want}")
    if launches != {k: v * len(steps) for k, v in want.items()}:
        raise AssertionError(f"run A launched {launches}")
    if not ok:
        raise AssertionError("harness: the resumed run differs from the "
                             "uninterrupted one")
    passed = [c for c, (c_ok, _) in c_gates.items() if c_ok]
    if passed:
        raise AssertionError(f"harness: the gate passes controls {passed}")
    best = min(run.best_checkpoints, key=lambda cm: cm[1]["loss"])[0]
    if (run.error is not None or len(starts) != 2 or len(kept) != 2
            or ckpt_losses != reported[:2]
            or run.checkpoint.path != best.path
            or sorted(os.path.basename(c.path) for c, _ in
                      run.best_checkpoints) != kept):
        raise AssertionError("harness: the run's bookkeeping is wrong")
    if not all(math.isfinite(e["loss"]) for e in steps):
        raise AssertionError("harness: non-finite loss")
    log(f"[p] phase (p) took {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# (q) the last entry points: the podracer handle, GPT stages through
# StagePipeline, the rllib command line
# ---------------------------------------------------------------------------

PODRACER_TICKS = 200
PODRACER_GATED = 3         # ticks whose learner metrics are held to the CPU's
PODRACER_RTOL = 1e-4       # |card - cpu| <= 1e-4 max(1, |cpu|), per metric
# GPT-2 small cut into 4 stages of 3 layers; 8 microbatches of [2, 1024].
STAGES = dict(n=4, microbatches=8, batch=2, seq=1024, channel_depth=4)


def podracer_invariants(outs, num_actors) -> list:
    """tests/test_podracer.py's _assert_invariants over every output: ->
    the conditions broken (none: [])."""
    bad = []
    if [o["tick"] for o in outs] != list(range(outs[0]["tick"],
                                               outs[0]["tick"] + len(outs))):
        bad.append("ticks not contiguous")
    if any(o["applied"] != o["tick"] + 1 for o in outs):
        bad.append("applied != tick + 1")
    if any(o["tick_skew"] or o["num_batches"] != num_actors for o in outs):
        bad.append("a batch missing or misaligned")
    for i in range(num_actors):
        seq = [o["versions"][i] for o in outs]
        if any(b < a for a, b in zip(seq, seq[1:])):
            bad.append(f"actor {i}'s versions regress")
    return bad


def _podracer_skipping_tick1():
    """A learner whose tick-1 update is skipped: it reports tick 0's
    metrics and leaves the weights as they were (the control)."""
    from ray_tpu_torch.podracer import runtime as prt

    class SkipTick1(prt._Learner):
        def learn(self, *batches):
            if batches[0]["tick"] != 1:
                out = super().learn(*batches)
                self._last = dict(out["metrics"])
                return out
            update = self._learner.update
            self._learner.update = lambda *a, **k: dict(self._last)
            try:
                return super().learn(*batches)
            finally:
                self._learner.update = update
    return SkipTick1


def _podracer_run(device, ticks, learner=None) -> dict:
    """PodracerRun(PodracerConfig(device=device)) in this process (no
    runtime), ``ticks`` ticks with a window of 1."""
    from ray_tpu_torch.models.convert import flatten
    from ray_tpu_torch.podracer import PodracerConfig, PodracerRun
    from ray_tpu_torch.podracer import runtime as prt
    with _patched(prt, "_Learner", learner or prt._Learner):
        run = PodracerRun(PodracerConfig(device=device))
    try:
        w0 = flatten(run._weights)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run.run(ticks, window=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = run.stats()
    finally:
        run.teardown()
    return dict(outs=outs, seconds=seconds, w0=w0, stats=stats,
                steps=sum(o["steps"] for o in outs))


def _podracer_gate(card, cpu) -> tuple:
    """-> (passed, reading): the first PODRACER_GATED ticks' learner
    metrics within PODRACER_RTOL of the CPU run's."""
    worst = 0.0
    for a, b in zip(card["outs"][:PODRACER_GATED],
                    cpu["outs"][:PODRACER_GATED]):
        if sorted(a["metrics"]) != sorted(b["metrics"]):
            return False, "metric names differ"
        for k, v in b["metrics"].items():
            d = abs(a["metrics"][k] - v) / max(1.0, abs(v))
            worst = max(worst, d if math.isfinite(d) else math.inf)
    return worst <= PODRACER_RTOL, (
        f"first {PODRACER_GATED} ticks' metrics within {worst:.2e} of the "
        f"CPU's (tol {PODRACER_RTOL:.0e})")


def phase_podracer() -> None:
    """(q1) PodracerRun at JAX's default widths (CartPole-v1, 2 gangs of 1
    actor, 1 env, fragment 16, hidden 32x32, minibatch 64) in this process
    (no runtime), the learner on the card, the actors' policy on the CPU:
    PODRACER_TICKS ticks beside the same run with device="cpu". Gates: the
    standing invariants over every tick of both runs, both runs from the
    same bootstrap weights, and the first ticks' learner metrics within
    PODRACER_RTOL of the CPU run's (TF32 off, phase a); a learner that
    skips tick 1's update must fail the metrics gate."""
    card = _podracer_run(None, PODRACER_TICKS)
    cpu = _podracer_run("cpu", PODRACER_TICKS)
    for label, r in (("card", card), ("CPU", cpu)):
        bad = podracer_invariants(r["outs"], 2)
        if bad or r["stats"]["ticks"] != PODRACER_TICKS:
            raise AssertionError(f"podracer on the {label}: {bad}")
    same_w0 = sorted(card["w0"]) == sorted(cpu["w0"]) and all(
        np.array_equal(card["w0"][k], cpu["w0"][k]) for k in cpu["w0"])
    ok, reading = _podracer_gate(card, cpu)
    same_rewards = [a["rewards"] == b["rewards"] for a, b in
                    zip(card["outs"][:PODRACER_GATED],
                        cpu["outs"][:PODRACER_GATED])]
    log(f"[q1] gate podracer: invariants hold over {PODRACER_TICKS} ticks "
        f"(card and CPU); bootstrap weights equal: {same_w0}; {reading}; "
        f"rewards of the gated ticks equal: {same_rewards}: "
        f"{'pass' if ok and same_w0 else 'fail'}")
    if not (ok and same_w0):
        raise AssertionError("podracer: the card run failed the gate")
    control = _podracer_run(None, PODRACER_GATED, _podracer_skipping_tick1())
    c_ok, c_reading = _podracer_gate(control, cpu)
    log(f"[q1] gate podracer, control, tick 1's update skipped (must fail): "
        f"{c_reading}: {'pass' if c_ok else 'fail'}")
    if c_ok:
        raise AssertionError("podracer: the control passed the gate")
    for label, r in (("card", card), ("CPU", cpu)):
        log(f"[q1] podracer, learner on the {label}: {PODRACER_TICKS} ticks "
            f"in {r['seconds']:.3f} s: {PODRACER_TICKS / r['seconds']:.1f} "
            f"ticks/s, {r['steps'] / r['seconds']:.0f} env steps/s (host "
            f"clock); final version {r['stats']['weight_version']}, "
            f"episode_reward_mean {r['stats']['episode_reward_mean']:.2f}")


def stage_setup(seed=SEED):
    """GPT-2 small (bf16, seed-0 weights drawn on the CPU, so that a
    caller that starts actors has not touched CUDA) in the stacked layout,
    and STAGES' microbatches of token ids: -> (cfg, {name: tensor},
    [token arrays])."""
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
    from ray_tpu_torch.parallel.pipeline import gpt_params_to_pp
    cfg = GPTConfig.gpt2_small()
    gen = torch.Generator().manual_seed(seed)
    pp = dict(gpt_params_to_pp(gpt_init(cfg, device="cpu", generator=gen))
              .named_parameters())
    rng = np.random.RandomState(seed)
    toks = [rng.randint(0, cfg.vocab_size, (STAGES["batch"], STAGES["seq"]))
            .astype(np.int64) for _ in range(STAGES["microbatches"])]
    return cfg, {k: v.detach() for k, v in pp.items()}, toks


def stage_gate(outs, whole) -> list:
    """The microbatches whose logits differ from the whole run's in any
    bit (hops of bf16 bits: equal arrays)."""
    return [i for i, (a, b) in enumerate(zip(outs, whole))
            if a[1] != b[1] or not np.array_equal(a[0], b[0])]


def phase_stages() -> None:
    """(q2) GPT-2 small cut into STAGES["n"] GPTStages of 3 layers (stage 0
    embeds, the last applies the final norm and the head), all on the card
    in this process behind the in-process runtime, through StagePipeline's
    run with channel_depth 4: STAGES["microbatches"] microbatches of [2,
    1024]. Each hop crosses as host bf16 bits (to_hop). Gates: every
    microbatch's logits equal, bit for bit, those of one GPTStage holding
    all 12 layers on the card (the same layers run whole); K1 launched 12
    times a microbatch, K2 and K3 never. Prints ms a microbatch beside the
    whole run's, and the bytes a hop."""
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel.pipeline import (GPTStage, StagePipeline,
                                                 stage_params, to_hop)
    from ray_tpu_torch.util import local_runtime
    cfg, pp, toks = stage_setup()
    n, m = STAGES["n"], STAGES["microbatches"]
    stages = [local_runtime.remote(GPTStage).remote(
        cfg, stage_params(pp, n, i), first=i == 0, last=i == n - 1)
        for i in range(n)]
    whole = GPTStage(cfg, stage_params(pp, 1, 0), first=True, last=True)
    saved = {k: kern.launches for k, kern in A.KERNELS.items()}
    with StagePipeline(stages, method="apply",
                       channel_depth=STAGES["channel_depth"]) as pipe:
        pipe.run(toks[:1])                  # warm-up: cuBLAS, the kernels
        for kern in A.KERNELS.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pipe.run(toks)
        torch.cuda.synchronize()
        pipe_ms = 1e3 * (time.perf_counter() - t0) / m
        launches = {k: kern.launches for k, kern in A.KERNELS.items()}
        stats = pipe.stats()
    t0 = time.perf_counter()
    ref = [whole.apply(t) for t in toks]
    torch.cuda.synchronize()
    whole_ms = 1e3 * (time.perf_counter() - t0) / m
    for k, v in saved.items():
        A.KERNELS[k].launches = v      # (g) reports the main path's (e)
    hop = to_hop(torch.zeros(STAGES["batch"], STAGES["seq"], cfg.d_model,
                             dtype=cfg.dtype))
    differ = stage_gate(outs, ref)
    want = {"flash_fwd": cfg.n_layers * m, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    log(f"[q2] gate stages: {m} microbatches through {n} stages, logits "
        f"{list(outs[0][0].shape)} ({outs[0][1]} bits) equal to the whole "
        f"run's bit for bit except microbatches {differ or 'none'}; "
        f"launches {launches} (want {want}); DAG {stats['ticks']} ticks, "
        f"state {stats['state']}: "
        f"{'pass' if not differ and launches == want else 'fail'}")
    if differ or launches != want:
        raise AssertionError("stages: the gate failed")
    log(f"[q2] stages: {pipe_ms:.2f} ms a microbatch through the pipeline, "
        f"{whole_ms:.2f} ms run whole (host clock, {m} microbatches of "
        f"{STAGES['batch']}x{STAGES['seq']}); a hop {hop[0].nbytes} bytes "
        f"(bf16 activations as int16 bits), the logits "
        f"{outs[0][0].nbytes} bytes (in process: no channel, a host copy "
        f"each way)")
    del stages, whole, outs, ref
    torch.cuda.empty_cache()


_CLI_TRAIN = re.compile(r"iter (\d+): reward_mean=\S+ episodes=\d+")


def _cli(args, tmp) -> subprocess.Popen:
    """Start ``python -m ray_tpu_torch`` with ``args``, this checkout on
    its path; ``_cli_lines`` reads it."""
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *args],
                         cwd=tmp, env=dict(os.environ, PYTHONPATH=root),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    p.t0 = time.perf_counter()
    return p


def _cli_lines(p) -> tuple:
    """-> (exit code, [(seconds since the start, line)])."""
    lines = [(time.perf_counter() - p.t0, line.rstrip("\n"))
             for line in p.stdout]
    return p.wait(timeout=300), lines


def phase_cli(ppo_ms) -> None:
    """(q3) The rllib command line as a user runs it, ``python -m
    ray_tpu_torch rllib``: train PPO on CartPole-v1 for 2 iterations with a
    checkpoint, on the card (the default), then evaluate that checkpoint on
    the card and on the CPU (--device cpu: the state loads onto another
    device), the two at once. Gates: exit 0 and JAX's lines; an unknown
    --algo exits with JAX's message (the command called in this process:
    it exits before anything is built). Prints ms an iteration (between
    the two iteration lines) beside phase (o)'s PPO iteration."""
    import tempfile

    from ray_tpu_torch.scripts.cli import build_parser
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ppo.ckpt")
        rc, train = _cli_lines(_cli(
            ["rllib", "train", "--algo", "PPO", "--env", "CartPole-v1",
             "--stop-iters", "2", "--checkpoint-path", ckpt], tmp))
        iters = [(t, line) for t, line in train if _CLI_TRAIN.fullmatch(line)]
        text = [line for _, line in train]
        ok = (rc == 0 and [_CLI_TRAIN.fullmatch(line).group(1)
                           for _, line in iters] == ["1", "2"]
              and any(line.startswith("best reward_mean: ") for line in text)
              and f"checkpoint written to {ckpt}" in text)
        runs = {d or "card": _cli(["rllib", "evaluate", "--algo", "PPO",
                                   "--env", "CartPole-v1", "--checkpoint-path",
                                   ckpt] + (["--device", d] if d else []), tmp)
                for d in (None, "cpu")}
        evals = {}
        for where, p in runs.items():
            rc_e, out = _cli_lines(p)
            evals[where] = [line for _, line in out
                            if line.startswith("mean_return=")]
            ok = ok and rc_e == 0 and re.fullmatch(
                r"mean_return=\d+\.\d\d over 5 episodes",
                (evals[where] or [""])[-1]) is not None
    args = build_parser().parse_args(["rllib", "train", "--algo", "Nope"])
    try:
        args.fn(args)
        unknown = None
    except SystemExit as e:
        unknown = str(e.code)
    ok = ok and unknown == (
        "error: unknown algorithm 'Nope'; see ray_tpu_torch.rllib.__all__ "
        "for available *Config classes")
    log(f"[q3] cli train: exit {rc}, {[line for _, line in iters]} + "
        f"{[x for x in text if x.startswith(('best', 'checkpoint'))]}; "
        f"evaluate {evals}; unknown algo: {unknown!r}: "
        f"{'pass' if ok else 'fail'}")
    if not ok:
        raise AssertionError(f"cli: {train} {evals} {unknown}")
    iter_ms = 1e3 * (iters[1][0] - iters[0][0])
    log(f"[q3] cli: iteration 2 took {iter_ms:.1f} ms (between the two "
        f"iteration lines, host clock) beside phase (o)'s PPO iteration "
        f"{ppo_ms:.1f} ms; the train command {train[-1][0]:.1f} s in all")


def phase_entry_points(ppo_ms) -> None:
    """(q) The last entry points, each gated (q1-q3)."""
    t = [time.perf_counter()]
    for part in (phase_podracer, phase_stages, lambda: phase_cli(ppo_ms)):
        part()
        t.append(time.perf_counter())
    log(f"[q] phase (q) took {t[-1] - t[0]:.1f} s (q1 {t[1] - t[0]:.1f}, "
        f"q2 {t[2] - t[1]:.1f}, q3 {t[3] - t[2]:.1f})")


# ---------------------------------------------------------------------------
# (f) kernel timing
# ---------------------------------------------------------------------------

def _time_ms(fn, flush) -> float:
    """Median over TIMED_RUNS of CUDA-event time, each run after writing
    a buffer larger than the 50 MB L2 so that inputs come from HBM."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(name, bh, s, d, dtype) -> tuple:
    """Least time for the work: bytes (each input read once, each output
    written once) over HBM bandwidth vs causal FLOPs over peak."""
    el = torch.finfo(dtype).bits // 8
    mat, row = bh * s * d * el, bh * s * 4
    pairs = bh * s * (s + 1) // 2                  # causal (q, k) pairs
    work = {"flash_fwd": (4 * mat + row, 4 * d * pairs),
            "flash_bwd_dq": (5 * mat + 2 * row, 6 * d * pairs),
            "flash_bwd_dkv": (6 * mat + 2 * row, 8 * d * pairs)}
    nbytes, flops = work[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def phase_timing() -> dict:
    from ray_tpu_torch.ops import attention as A
    m = MAIN
    b, h, s, d, dt = m["batch"], m["heads"], m["seq"], m["head_dim"], m["dtype"]
    bh = b * h
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    q, k, v, do = _inputs(bh, s, s, d, dt, gen)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=True, sm_scale=scale)
    fw = dict(block_q=128, block_k=128)
    o, lse = A.flash_fwd_plain(q, k, v, **fw, **kw)
    delta = (do.float() * o.float()).sum(-1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    saved = {n: kern.launches for n, kern in A.KERNELS.items()}

    runs = {
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, **fw, **kw),
                      lambda: A.flash_fwd_plain(q, k, v, **fw, **kw)),
        "flash_bwd_dq": (
            lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: A.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)),
        "flash_bwd_dkv": (
            lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
            lambda: A.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)),
    }
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q4, k4, v4))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        # K2 + K3's work together (dQ, dK, dV), without a forward.
        torch.autograd.grad(out_g, (qg, kg, vg), do4, retain_graph=True)

    lib = {"flash_fwd": _time_ms(sdpa_fwd, flush)}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = _time_ms(sdpa_bwd, flush)
    fwd_bwd = _time_ms(sdpa_fwd_bwd, flush)
    log(f"[f] scaled_dot_product_attention: forward {lib['flash_fwd']:.3f} "
        f"ms, backward alone {lib['flash_bwd_dq']:.3f} ms, forward+backward "
        f"{fwd_bwd:.3f} ms")
    out = {}
    for name, (kernel, plain) in runs.items():
        # Order plain, kernel, kernel, plain; each side reports its median.
        p1 = _time_ms(plain, flush)
        k1 = _time_ms(kernel, flush)
        k2 = _time_ms(kernel, flush)
        p2 = _time_ms(plain, flush)
        bound, by, nbytes, flops = _bound_ms(name, bh, s, d, dt)
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=lib[name], bound_ms=bound, bound_by=by)
        log(f"[f] {name}: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/"
            f"{p2:.3f} ms, {LIBRARY_CALLS[name]} {lib[name]:.3f} ms, bound "
            f"{bound:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
    for n, kern in A.KERNELS.items():
        kern.launches = saved[n]   # timing launches are not main-path ones
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on the card only", file=sys.stderr)
        return 2
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    errs = phase_kernels()
    phase_forward()
    launches, e_step0, e_step_ms = phase_train()
    timing = phase_timing()
    phase_moe()
    phase_medium()
    phase_strategies(e_step0)
    phase_pipeline()
    phase_rllib()
    phase_offpolicy()
    algo_ms = phase_algorithms()
    phase_harness(e_step_ms)
    phase_entry_points(algo_ms["PPO"])
    kernels = [dict(name=n, route="cuda", source=SOURCES[n],
                    replaces=REPLACES[n],
                    launches=launches[n], max_abs_err=errs[n],
                    library=LIBRARY_CALLS[n], **timing[n])
               for n in REPLACES]
    log(f"[g] total {time.perf_counter() - t_start:.1f} s on {dev['smi']} "
        f"(the script before phase (q): 327.4 s on an NVIDIA H100 80GB "
        f"HBM3 at 700.00 W, PERF.md run H2)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
