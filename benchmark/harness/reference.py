"""The plain reference: the decoder and its AdamW steps in plain PyTorch,
float32 with TF32 off, written from the architecture's description
(RoPE over the whole head, RMSNorm, SwiGLU, causal softmax attention, mean
next-token cross-entropy; optax's AdamW). It imports nothing of the program
and takes nothing the program made: its weights are drawn again from the
seed (``weights.block_weights``), its batches are the benchmark's tokens.

It runs after the measured window, once the program's state is freed,
layer by layer and one sequence at a time, so that it fits beside its own
fp32 weights and moments: a forward pass keeps each layer's input, the
backward pass runs each layer again with autograd on, and each block is
updated as soon as its gradient is whole. Over several ranks (a process
group initialised), each takes its share of the rows, as ZeRO does
(``_Group``).

``precision="fp8"`` is the control: every product takes its inputs rounded
to float8 (e4m3 forward, e5m2 for gradients, one scale per tensor), the
step that would tempt a change below the configuration's bfloat16."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from harness.spec import ModelSpec
from harness.weights import block_weights

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under one scale that maps its largest
    magnitude to the format's largest, returned in float32."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / _FP8_MAX[fmt]
    return (t / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def _matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def _rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope_tables(spec: ModelSpec, seq: int, device):
    half = spec.head_dim // 2
    freqs = spec.rope_theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=device) / half)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """x: [H, S, D], the first half of each head rotated against the
    second."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer_forward(spec: ModelSpec, w: Dict[str, torch.Tensor], x, rope,
                  mm=torch.matmul):
    """One decoder layer on one sequence x [S, d]; ``w`` by the names under
    the layer (``attn.wq``, ``mlp.w_up``, ``ln1.scale``, ...)."""
    s, d = x.shape
    h, hd = spec.n_heads, spec.head_dim
    cos, sin = rope
    a = _rmsnorm(x, w["ln1.scale"], spec.norm_eps)

    def heads(name):
        return mm(a, w[name]).view(s, h, hd).transpose(0, 1)

    q = _rope(heads("attn.wq"), cos, sin)
    k = _rope(heads("attn.wk"), cos, sin)
    v = heads("attn.wv")
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(probs, v).transpose(0, 1).reshape(s, d)
    x = x + mm(o, w["attn.wo"])
    m = _rmsnorm(x, w["ln2.scale"], spec.norm_eps)
    return x + mm(F.silu(mm(m, w["mlp.w_gate"])) * mm(m, w["mlp.w_up"]),
                  w["mlp.w_down"])


@dataclass
class AdamWConfig:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4


@dataclass
class Readings:
    """What the check compares: each step's loss, the first gradient's
    norm by leaf, and the norm by leaf of the parameters' change over the
    steps taken."""
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class _Group:
    """The ranks the reference runs on: each takes its share of the
    global batch's rows and holds every weight whole and its share of each
    leaf's moments (each leaf flattened and cut in ``world`` chunks);
    gradients are reduce-scattered, each rank updates its chunk, and the
    weights are gathered whole again. One rank: no collective."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist if dist.is_available() and dist.is_initialized() \
            else None
        self.world = self.dist.get_world_size() if self.dist else 1
        self.rank = self.dist.get_rank() if self.dist else 0

    def chunk(self, n: int) -> int:
        return -(-n // self.world)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.dist:
            self.dist.all_reduce(t)
        return t

    def scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the sum over ranks of ``flat`` (its length a
        multiple of the world)."""
        if not self.dist:
            return flat
        out = torch.empty(flat.numel() // self.world, dtype=flat.dtype,
                          device=flat.device)
        self.dist.reduce_scatter_tensor(out, flat)
        return out

    def gather(self, flat: torch.Tensor, mine: torch.Tensor) -> None:
        if self.dist:
            self.dist.all_gather_into_tensor(flat, mine)


class Reference:
    """The reference's training state: fp32 weights drawn from ``seed``,
    whole on every rank, and this rank's chunk of AdamW's moments."""

    def __init__(self, spec: ModelSpec, seed: int, opt: AdamWConfig,
                 device, precision: str = "fp32"):
        if spec.tied:
            raise ValueError("the reference has no tied head")
        self.spec, self.seed, self.opt = spec, seed, opt
        self.device = torch.device(device)
        self.mm = _matmul(precision)
        self.group = _Group()
        self.params: Dict[str, torch.Tensor] = {}
        self.flat: Dict[str, torch.Tensor] = {}
        for b in range(len(spec.blocks())):
            for n, w in block_weights(spec, seed, b, self.device).items():
                c = self.group.chunk(w.numel())
                flat = torch.zeros(c * self.group.world, device=self.device)
                flat[:w.numel()] = w.reshape(-1)
                self.flat[n] = flat
                self.params[n] = flat[:w.numel()].view(w.shape)
        c = {n: f.numel() // self.group.world for n, f in self.flat.items()}
        self.mu = {n: torch.zeros(c[n], device=self.device) for n in c}
        self.nu = {n: torch.zeros(c[n], device=self.device) for n in c}
        self.count = 0

    def _update(self, grads: Dict[str, torch.Tensor],
                grad_norms: Optional[Dict[str, float]]) -> None:
        o, t, grp = self.opt, self.count, self.group
        bc1 = 1.0 - o.b1 ** t
        bc2 = 1.0 - o.b2 ** t
        for n, g in grads.items():
            flat = self.flat[n]
            whole = torch.zeros_like(flat)
            whole[:g.numel()] = g.reshape(-1)
            g = grp.scatter(whole)
            del whole
            if grad_norms is not None:
                grad_norms[n] = math.sqrt(float(grp.sum(
                    torch.sum(g.double() ** 2))))
            c = g.numel()
            p = flat[grp.rank * c:(grp.rank + 1) * c]
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(o.b1).add_(g, alpha=1.0 - o.b1)
            nu.mul_(o.b2).addcmul_(g, g, value=1.0 - o.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + o.eps)
            mine = p - o.lr * (upd + o.weight_decay * p)
            if grp.world == 1:
                p.copy_(mine)
            else:
                grp.gather(flat, mine)

    def _leaves(self, names: Sequence[str], prefix: str = ""):
        """The named parameters as autograd leaves sharing their storage,
        keyed by their names under ``prefix``."""
        return {n[len(prefix):]: self.params[n].detach().requires_grad_()
                for n in names}

    def step(self, tokens: torch.Tensor,
             grad_norms: Optional[Dict[str, float]] = None) -> float:
        """One AdamW step on the global batch ``tokens`` [B, S + 1], this
        rank taking its share of the rows; -> the mean next-token loss
        over the whole batch before the step. ``grad_norms``, when given,
        is filled with each leaf's gradient norm."""
        spec, mm, grp = self.spec, self.mm, self.group
        self.count += 1
        rows = tokens.shape[0] // grp.world
        n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
        tokens = tokens[grp.rank * rows:(grp.rank + 1) * rows]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        rope = _rope_tables(spec, s, self.device)
        blocks = spec.blocks()

        def finish(leaves: Dict[str, torch.Tensor], prefix: str = ""):
            self._update({prefix + k: v.grad for k, v in leaves.items()},
                         grad_norms)

        xs = [self.params["embed.table"][inputs]]
        with torch.no_grad():
            for i in range(spec.n_layers):
                w = {n[len(f"layers.{i}."):]: self.params[n]
                     for n, _ in blocks[i + 1]}
                xs.append(torch.stack([layer_forward(spec, w, xs[-1][r],
                                                     rope, mm)
                                       for r in range(b)]))
        head = self._leaves(["final_norm.scale", "lm_head"])
        dx = torch.empty_like(xs[-1])
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for r in range(b):
            x = xs[-1][r].detach().requires_grad_()
            logits = mm(_rmsnorm(x, head["final_norm.scale"], spec.norm_eps),
                        head["lm_head"])
            nll = torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, 1, targets[r][:, None])[:, 0]
            loss = nll.sum() / n_tokens
            loss.backward()
            dx[r] = x.grad
            total += loss.detach().double()
            del logits, nll, loss
        finish(head)
        xs.pop()
        for i in reversed(range(spec.n_layers)):
            prefix = f"layers.{i}."
            w = self._leaves([n for n, _ in blocks[i + 1]], prefix)
            x_in = xs.pop()
            for r in range(b):
                x = x_in[r].detach().requires_grad_()
                layer_forward(spec, w, x, rope, mm).backward(dx[r])
                dx[r] = x.grad
            del x_in
            finish(w, prefix)
        table = torch.zeros_like(self.params["embed.table"])
        table.index_add_(0, inputs.reshape(-1), dx.reshape(b * s, -1))
        del dx, xs
        self._update({"embed.table": table}, grad_norms)
        return float(grp.sum(total))

    def change_norms(self) -> Dict[str, float]:
        """‖θ - θ0‖ by leaf, θ0 drawn again from the seed."""
        out = {}
        for b in range(len(self.spec.blocks())):
            w0 = block_weights(self.spec, self.seed, b, self.device)
            out.update({n: _norm(self.params[n] - w) for n, w in w0.items()})
        return out


def run_reference(spec: ModelSpec, seed: int, batches: Sequence[torch.Tensor],
                  opt: AdamWConfig, device,
                  precision: str = "fp32") -> Readings:
    """``len(batches)`` steps of the reference from the seed's weights."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(spec, seed, opt, device, precision)
        norms: Dict[str, float] = {}
        losses = [ref.step(t.to(ref.device), norms if i == 0 else None)
                  for i, t in enumerate(batches)]
        change = ref.change_norms()
        del ref
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return Readings(losses, norms, change)
