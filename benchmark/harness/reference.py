"""The plain reference: a decoder and its AdamW steps (optax's AdamW) in
plain PyTorch, float32 with TF32 off. This is the runner the
architectures share: each architecture's own layer and head
(``archs/<arch>/reference.py``, written from its description) run under
it. It imports nothing of the program and takes nothing the program
made: its weights are drawn again from the seed (``weights.
block_weights``), its batches are the benchmark's tokens.

It runs after the measured window, once the program's state is freed,
layer by layer and one sequence at a time, so that it fits beside its own
fp32 weights and moments: a forward pass without gradients keeps each
layer's input, the backward pass runs each layer again with autograd on,
and each block is updated as soon as its gradient is whole. Over several
ranks (a process group initialised), each takes its share of the rows, as
ZeRO does (``_Group``).

What the runner calls of an architecture's ``reference.py``, with ``mm``
the runner's matrix product:

- ``prepare(spec, seq, device) -> ctx``: what every layer of a step
  shares (RoPE's tables);
- ``layer(spec, i, w, x, ctx, mm, stats)``: layer ``i`` on one sequence x
  [S, d], ``w`` its leaves by the names under ``layers.<i>.``; returns
  its output, or ``(output, term, row_stats)``. In the pass without
  gradients ``stats`` is None, and ``row_stats`` (a tensor, or None) are
  this sequence's statistics, which the runner sums over every row and
  rank; in the recompute ``stats`` is that sum, and ``term`` (a scalar,
  or None) is this sequence's share of a term of the loss, such as an
  auxiliary loss of experts, which is added to the loss and whose
  gradient flows;
- ``head(spec, w, x, targets, mm)``: the next-token loss of one sequence,
  summed over its positions, ``w`` block 0's leaves but ``embed.table``
  (which the runner's lookup reads).

``precision="fp8"`` is the control: every product takes its inputs rounded
to float8 (e4m3 forward, e5m2 for gradients, one scale per tensor), the
step that would tempt a change below the configuration's bfloat16."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from harness import arch
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


def _layer_out(out) -> Tuple:
    """An architecture's ``layer`` result as (output, term, row_stats)."""
    return (out, None, None) if isinstance(out, torch.Tensor) else out


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

    def __init__(self, spec, seed: int, opt: AdamWConfig, device,
                 precision: str = "fp32"):
        self.spec, self.seed, self.opt = spec, seed, opt
        self.arch = arch.module(spec, "reference")
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
        spec, mm, grp, model = self.spec, self.mm, self.group, self.arch
        self.count += 1
        rows = tokens.shape[0] // grp.world
        n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
        tokens = tokens[grp.rank * rows:(grp.rank + 1) * rows]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        ctx = model.prepare(spec, s, self.device)
        blocks = spec.blocks()
        n_layers = len(blocks) - 1

        def finish(leaves: Dict[str, torch.Tensor], prefix: str = ""):
            self._update({prefix + k: v.grad for k, v in leaves.items()},
                         grad_norms)

        xs = [self.params["embed.table"][inputs]]
        stats: List[Optional[torch.Tensor]] = []
        with torch.no_grad():
            for i in range(n_layers):
                w = {n[len(f"layers.{i}."):]: self.params[n]
                     for n, _ in blocks[i + 1]}
                outs = [_layer_out(model.layer(spec, i, w, xs[-1][r], ctx, mm,
                                               None))
                        for r in range(b)]
                xs.append(torch.stack([y for y, _, _ in outs]))
                row = [st for _, _, st in outs if st is not None]
                stats.append(grp.sum(torch.stack(row).sum(dim=0)) if row
                             else None)
                del outs, row
        head = self._leaves([n for n, _ in blocks[0] if n != "embed.table"])
        dx = torch.empty_like(xs[-1])
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for r in range(b):
            x = xs[-1][r].detach().requires_grad_()
            loss = model.head(spec, head, x, targets[r], mm) / n_tokens
            loss.backward()
            dx[r] = x.grad
            total += loss.detach().double()
            del loss
        finish(head)
        xs.pop()
        for i in reversed(range(n_layers)):
            prefix = f"layers.{i}."
            w = self._leaves([n for n, _ in blocks[i + 1]], prefix)
            x_in = xs.pop()
            for r in range(b):
                x = x_in[r].detach().requires_grad_()
                y, term, _ = _layer_out(model.layer(spec, i, w, x, ctx, mm,
                                                    stats[i]))
                if term is None:
                    y.backward(dx[r])
                else:
                    torch.autograd.backward([y, term],
                                            [dx[r], torch.ones_like(term)])
                    total += term.detach().double()
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


def run_reference(spec, seed: int, batches: Sequence[torch.Tensor],
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
