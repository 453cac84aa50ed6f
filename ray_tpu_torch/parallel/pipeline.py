"""Pipeline parallelism: the counterpart of ``ray_tpu/parallel/pipeline.py``.

The GPT's layers are stacked on a leading layer axis (``StackedGPT``, the
JAX ``stacked/...`` layout: ``gpt_params_to_pp`` / ``pp_params_to_gpt``),
which the ``pp`` and ``pp_tp`` rules split over the 'pipeline' axis: each
rank keeps its stage's L/S layers (``parallel.sharding.shard_params``), and
under ``pp_tp`` the Megatron slices of them over 'tensor'.

``make_gpt_pp_loss(cfg, mesh, num_microbatches)`` is the GPipe loss, one
process per stage. JAX runs the schedule as one SPMD program (a scan over
M + S - 1 ticks with ``ppermute`` between stages) and gets the backward by
transposing it. torch cannot transpose a send, so the port runs two
schedules by hand over the pipeline group (``Mesh.group("pipeline")``):

- forward: the M microbatches in order; stage 0 embeds, every other stage
  receives its input from the stage before, the last stage computes the
  head loss. JAX also computes the bubble ticks, whose outputs never reach
  the loss; the port skips them.
- backward: the microbatches in reverse; the last stage runs backward from
  its loss, every earlier stage from the gradient it receives
  (``torch.autograd.backward(y, grad_tensors=dy)``), and each stage but
  the first sends its input's gradient back.

Each pair of stages posts its sends and receives in the same order in both
passes (NCCL matches point-to-point operations by order, not by tag).

The train step (``train/train_step.py``) takes the loss object as its
``loss_fn``: it calls ``forward_backward(model, batch)`` in place of
``loss.backward()``, and sums the loss, and every gradient of a weight not
split over the axes in ``partial_axes`` ("pipeline"), over those axes too:
only the last stage holds the loss, and the embedding, the final norm and
the head, whole on every stage, get their parts from the first stage (the
lookup) and the last (the head), as JAX's transpose of a replicated input
sums them. Called as ``loss(model, batch)`` it runs the forward schedule
alone, without a graph (``make_eval_step``).

The head is the reference's: a full ``log_softmax`` over fp32 logits with
the ``tgt >= 0`` mask, not ``chunked_xent``. Under ``cfg.remat`` each layer
is recomputed whole, whatever ``remat_policy`` says, as in JAX. Tensor
parallelism inside a stage uses the Megatron pair ``copy_to`` /
``reduce_from`` where JAX uses ``psum`` over 'tensor'.

``StagePipeline`` is the MPMD route (JAX's :256): a linear chain of actor
stages compiled onto the runtime's channels, each stage its own program.
``GPTStage`` is such a stage of the GPT, built from ``StackedGPT``'s layers
(``stage_params`` cuts the stacked weights into stages); activations cross
between stages as host arrays (``to_hop`` / ``from_hop``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import device_where, resolve_device
from ray_tpu_torch.models import convert
from ray_tpu_torch.models.gpt import GPT, GPTConfig, _rmsnorm, _rope, gpt_init
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.parallel.mesh import Axis, Mesh, all_sum
from ray_tpu_torch.parallel.tensor_parallel import (copy_to, reduce_from,
                                                    take_part)
from ray_tpu_torch.util.held import held_result

# The stacked weights of a layer, in the order _layer takes them, with the
# dim of each per-layer weight that Megatron splits over 'tensor'.
_LAYER = ("ln1.scale", "ln2.scale", "attn.wq", "attn.wk", "attn.wv",
          "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")
_TENSOR_DIM = {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0,
               "mlp.w_gate": 1, "mlp.w_up": 1, "mlp.w_down": 0}


def _fill(node: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """``node`` with ``tree``'s tensors registered as parameters under
    their keys, each level in sorted order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            node.add_module(key, _fill(nn.Module(), val))
        else:
            node.register_parameter(key, nn.Parameter(val))
    return node


class StackedGPT(nn.Module):
    """The GPT in the pipeline layout, fp32 master weights under JAX's
    names: ``embed.table``, ``final_norm.scale``, ``lm_head`` and
    ``stacked.<block>.<weight>`` with the layers on dim 0
    (``stacked.attn.wq`` [L, d, d]), each level's keys registered in
    sorted order."""

    def __init__(self, cfg: GPTConfig, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        _fill(self, convert.unflatten(dict(params)))

    def check_placement(self, placement) -> None:
        """Raise ValueError where ``placement`` splits the heads over
        'tensor' unevenly, or a weight outside ``stacked`` over
        'pipeline'."""
        for name, _ in self.named_parameters():
            if (not name.startswith("stacked.")
                    and placement.split_dim(name, "pipeline") is not None):
                raise ValueError(f"{name}: only the stacked layers split "
                                 "over 'pipeline'")
        t = placement.mesh.shape["tensor"]
        if (placement.split_dim("stacked.attn.wq", "tensor") is not None
                and self.cfg.n_heads % t):
            raise ValueError(f"n_heads={self.cfg.n_heads} not divisible by "
                             f"tp={t}")


def _stack(parts: Sequence[Any]):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack([p.detach() for p in parts])
    return np.stack([np.asarray(p) for p in parts])


def gpt_params_to_pp(params):
    """The GPT's parameters in the pipeline layout: identical leaves
    stacked on a leading layer axis. A ``GPT`` module (whole, not placed)
    gives a ``StackedGPT``; a JAX-shaped tree (``{"layers": [...], ...}``,
    numpy or torch leaves) gives the tree with ``stacked`` in place of
    ``layers``, as the JAX function does."""
    if isinstance(params, GPT):
        if getattr(params, "placement", None) is not None:
            raise ValueError("convert a whole model, before shard_params")
        tree = gpt_params_to_pp(convert.unflatten(
            {n: p.detach() for n, p in params.named_parameters()}))
        flat = {n: t.clone() for n, t in convert.flatten(tree).items()}
        return StackedGPT(params.cfg, flat)
    layers = [convert.flatten(layer) for layer in params["layers"]]
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stacked"] = convert.unflatten(
        {key: _stack([layer[key] for layer in layers]) for key in layers[0]})
    return out


def pp_params_to_gpt(pp_params, n_layers: int):
    """Inverse of ``gpt_params_to_pp`` (checkpoint interchange): a whole
    ``StackedGPT`` gives a ``GPT`` on its device, a tree the tree with
    ``layers``."""
    if isinstance(pp_params, StackedGPT):
        if getattr(pp_params, "placement", None) is not None:
            raise ValueError("convert a whole model (gather it first: "
                             "models.convert.params_to_numpy)")
        tree = pp_params_to_gpt(convert.unflatten(
            {n: p.detach() for n, p in pp_params.named_parameters()}),
            n_layers)
        device = next(pp_params.parameters()).device
        model = gpt_init(pp_params.cfg, device=device,
                         generator=torch.Generator(device=device))
        model.load_state_dict({n: t.clone() for n, t in
                               convert.flatten(tree).items()})
        return model
    stacked = convert.flatten(pp_params["stacked"])
    out = {k: v for k, v in pp_params.items() if k != "stacked"}
    out["layers"] = [convert.unflatten({k: v[i] for k, v in stacked.items()})
                     for i in range(n_layers)]
    return out


# ---------------------------------------------------------------------------
# One stage
# ---------------------------------------------------------------------------

def _pp_attention(x, wq, wk, wv, wo, cfg: GPTConfig, positions, group):
    """Attention on this rank's heads (column-parallel q, k, v; the
    row-parallel output projection summed over ``group``)."""
    b, s, _ = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    h = wq.shape[1] // hd
    x = copy_to(x, group)

    def heads(w):
        return (x @ w.to(dt)).reshape(b, s, h, hd).transpose(1, 2)

    q = _rope(heads(wq), cfg.rope_theta, positions)
    k = _rope(heads(wk), cfg.rope_theta, positions)
    v = heads(wv)
    if cfg.attention == "reference":
        o = mha_reference(q, k, v, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, h * hd)
    return reduce_from(o @ wo.to(dt), group)


def _pp_mlp(x, w_gate, w_up, w_down, cfg: GPTConfig, group):
    dt = cfg.dtype
    x = copy_to(x, group)
    gate = x @ w_gate.to(dt)
    up = x @ w_up.to(dt)
    return reduce_from((F.silu(gate) * up) @ w_down.to(dt), group)


def _layer(x, positions, cfg: GPTConfig, group, ln1, ln2, wq, wk, wv, wo,
           w_gate, w_up, w_down):
    eps = cfg.rmsnorm_eps
    h = x + _pp_attention(_rmsnorm(x, ln1, eps), wq, wk, wv, wo, cfg,
                          positions, group)
    return h + _pp_mlp(_rmsnorm(h, ln2, eps), w_gate, w_up, w_down, cfg,
                       group)


def _head_loss(model: StackedGPT, y, tgt, cfg: GPTConfig):
    """(sum of the masked nll, number of unmasked targets) of one
    microbatch: full fp32 log_softmax, targets below 0 masked."""
    xf = _rmsnorm(y, model.final_norm.scale, cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        logits = xf @ model.embed.table.to(cfg.dtype).t()
    else:
        logits = xf @ model.lm_head.to(cfg.dtype)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt.clamp_min(0)[..., None])[..., 0]
    mask = (tgt >= 0).float()
    return torch.sum(nll * mask), torch.sum(mask)


class PipelineLoss:
    """The GPipe loss of ``make_gpt_pp_loss`` (module doc)."""

    partial_axes = ("pipeline",)

    def __init__(self, cfg: GPTConfig, mesh: Mesh, num_microbatches: int):
        n_stages = mesh.shape["pipeline"]
        tp = mesh.shape["tensor"]
        if cfg.n_layers % n_stages != 0:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                             f"pipeline={n_stages}")
        if cfg.n_experts > 0:
            raise ValueError("pipeline preset supports dense MLP layers (use "
                             "'ep' compositions for MoE)")
        if cfg.n_heads % tp != 0:
            raise ValueError(f"n_heads={cfg.n_heads} not divisible by "
                             f"tp={tp}")
        self.cfg, self.mesh, self.num_microbatches = cfg, mesh, num_microbatches

    def __call__(self, model: StackedGPT, batch: Dict[str, torch.Tensor]):
        """This rank's share of the loss (0 but on the last stage), from the
        forward schedule alone, without a graph."""
        with torch.no_grad():
            return self._run(model, batch, backward=False)

    def forward_backward(self, model: StackedGPT,
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Both schedules: this rank's parameters' gradients accumulate in
        ``.grad``; returns this rank's share of the loss, detached."""
        return self._run(model, batch, backward=True)

    def _weights(self, model: StackedGPT) -> Tuple[List[tuple], Axis]:
        """Per local layer, its weights in ``_layer``'s order, at this
        rank's part of 'tensor' (a weight held whole is taken in part),
        and the tensor axis."""
        placement = getattr(model, "placement", None)
        tensor = self.mesh.axis("tensor")
        ws = []
        for name in _LAYER:
            w = model.get_parameter("stacked." + name)
            split = (placement is not None and placement.split_dim(
                "stacked." + name, "tensor") is not None)
            if name in _TENSOR_DIM and tensor.size > 1 and not split:
                w = take_part(w, 1 + _TENSOR_DIM[name], tensor.index,
                              tensor.size, tensor.group)
            ws.append(w.unbind(0))
        return list(zip(*ws)), tensor

    def _stage(self, x, positions, layers, tensor):
        for weights in layers:
            if self.cfg.remat:
                x = checkpoint(_layer, x, positions, self.cfg, tensor.group,
                               *weights, use_reentrant=False)
            else:
                x = _layer(x, positions, self.cfg, tensor.group, *weights)
        return x

    def _run(self, model, batch, backward: bool) -> torch.Tensor:
        cfg, m_count = self.cfg, self.num_microbatches
        pipe = self.mesh.axis("pipeline")
        first, last = pipe.index == 0, pipe.index == pipe.size - 1
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        if b % m_count != 0:
            raise ValueError(f"per-shard batch {b} not divisible by "
                             f"microbatches {m_count}")
        mb = b // m_count
        dev = model.embed.table.device
        positions = torch.arange(s, device=dev)[None, :].expand(mb, s)
        # The global count of targets, known before the schedule: the last
        # stage runs each microbatch's backward from its final share.
        denom = torch.clamp_min(all_sum((targets >= 0).float().sum()), 1.0)
        shape = (mb, s, cfg.d_model)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        layers, tensor = self._weights(model)
        saved = []
        for m in range(m_count):
            rows = slice(m * mb, (m + 1) * mb)
            if first:
                x = model.embed.table.to(cfg.dtype)[inputs[rows]]
            else:
                x = _recv(shape, cfg.dtype, dev, pipe, pipe.index - 1)
                x.requires_grad_(backward)
            y = self._stage(x, positions, layers, tensor)
            if last:
                lsum, _ = _head_loss(model, y, targets[rows], cfg)
                y = lsum / denom
                total = total + y.detach()
            else:
                _send(y.detach(), pipe, pipe.index + 1)
            if backward:
                saved.append((x, y))
        if backward:
            for m in reversed(range(m_count)):
                x, y = saved[m]
                saved[m] = None
                if last:
                    torch.autograd.backward(y)
                else:
                    dy = _recv(y.shape, y.dtype, dev, pipe, pipe.index + 1)
                    torch.autograd.backward(y, grad_tensors=dy)
                if not first:
                    _send(x.grad, pipe, pipe.index - 1)
        return total


def _send(t: torch.Tensor, pipe: Axis, stage: int) -> None:
    dist.send(t.contiguous(), dist.get_global_rank(pipe.group, stage),
              group=pipe.group)


def _recv(shape, dtype, device, pipe: Axis, stage: int) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(buf, dist.get_global_rank(pipe.group, stage), group=pipe.group)
    return buf


def make_gpt_pp_loss(cfg: GPTConfig, mesh: Mesh,
                     num_microbatches: int) -> PipelineLoss:
    """The GPipe loss over ``mesh``'s 'pipeline' axis (module doc), for
    ``make_train_step(loss, ..., mesh, "pp" | "pp_tp")``. The batch is
    ``{"tokens": [B, S+1]}``, B the global batch, whose rows the step
    splits over 'data'; each data shard's rows must divide into
    ``num_microbatches``."""
    return PipelineLoss(cfg, mesh, num_microbatches)


# ---------------------------------------------------------------------------
# MPMD stage pipelines over the runtime's compiled-DAG channels
# ---------------------------------------------------------------------------


class StagePipeline:
    """A linear chain of actor stages compiled onto reusable channels:
    ``ray_tpu/parallel/pipeline.py``'s ``StagePipeline``.

    ``stages`` are live actor handles of ``runtime``; each tick flows the
    input through ``stage[0].method -> stage[1].method -> ...``, one
    channel write per hop. ``channel_depth`` microbatches can be in
    flight at once, and backpressure from the slowest stage bounds memory.

    ``runtime``: ``ray_tpu`` (after ``ray_tpu.init()`` and ``import
    ray_tpu.dag.compiled``), whose ``CompiledDAG`` runs the chain over shm
    channels with in-place recovery under ``tick_replay``; or None, and
    ``util.local_runtime``'s DAG runs the chain in this process (stages
    made with ``local_runtime.remote(cls).remote(...)``), each tick at
    submission.

    Usage::

        pipe = StagePipeline([s0, s1, s2], method="apply", channel_depth=4,
                             runtime=ray_tpu)
        outs = pipe.run(microbatches)      # pipelined map, order-preserving
        pipe.teardown()                    # or `with StagePipeline(...)`
    """

    def __init__(self, stages, method: str = "__call__", *,
                 channel_depth: int = 4, max_message_size: int = 1 << 20,
                 tick_replay: bool = True, runtime=None):
        """tick_replay=True (default) arms the compiled DAG's in-place
        recovery: a stage actor dying mid-stream is restarted (give the
        stages ``max_restarts``), and every unacknowledged microbatch is
        replayed exactly once. tick_replay=False keeps the typed fail-fast
        ``DagExecutionError``."""
        from ray_tpu_torch.train.worker_group import required_attr
        from ray_tpu_torch.util import local_runtime
        if not stages:
            raise ValueError("StagePipeline needs at least one stage")
        rt = local_runtime if runtime is None else runtime
        input_node = required_attr(rt, "dag.InputNode", "ray_tpu.dag")
        compiled = required_attr(rt, "dag.compiled.CompiledDAG",
                                 "ray_tpu.dag.compiled")
        with input_node() as inp:
            node = inp
            for handle in stages:
                node = getattr(handle, method).bind(node)
        self.n_stages = len(stages)
        self.channel_depth = channel_depth
        self._rt = rt
        self._in_process = rt is local_runtime
        self._dag = compiled.compile(
            node, channel_depth=channel_depth,
            max_message_size=max_message_size, tick_replay=tick_replay)

    def submit(self, value):
        """Inject one microbatch; returns a ref. The input write blocks
        once ``channel_depth`` ticks are in flight: a single-threaded
        caller collects at least every ``channel_depth`` submissions
        (``run`` does the windowing)."""
        return self._dag.execute_async(value)

    def run(self, inputs, timeout: Optional[float] = None) -> list:
        """Pipelined map over ``inputs``, outputs in input order, with at
        most ``channel_depth`` ticks uncollected. Over a runtime each
        output is copied as it arrives, while the object it came in stays
        held: an output above a channel slot reaches the caller as a view
        of object-store memory, which the store reuses once the last stage
        lets the object go (ROADMAP R-11), and ``run`` returns them all at
        the end."""
        pending: deque = deque()
        out = []

        def collect():
            ref = pending.popleft()
            out.append(ref.result(timeout) if self._in_process
                       else held_result(self._rt,
                                        lambda: ref.result(timeout)))

        for x in inputs:
            if len(pending) >= self.channel_depth:
                collect()
            pending.append(self.submit(x))
        while pending:
            collect()
        return out

    def stats(self) -> dict:
        return self._dag.stats()

    def teardown(self):
        self._dag.teardown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.teardown()
        return False


def to_hop(t: torch.Tensor) -> tuple:
    """An activation as it crosses a channel: (host array, dtype name).
    numpy has no bf16, so a bf16 tensor travels as its bits (int16)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def from_hop(hop: tuple, device) -> torch.Tensor:
    """``to_hop``'s inverse, bit for bit, on ``device``."""
    arr, dtype = hop
    if not arr.flags.writeable:        # a zero-copy view of a channel slot
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def stage_params(pp_params: Mapping[str, Any], n_stages: int,
                 index: int) -> Dict[str, Any]:
    """Stage ``index`` of ``n_stages``'s weights from a flat stacked-layout
    dict (``gpt_params_to_pp``, flattened): its L/S layers of every
    ``stacked.*`` weight; the embedding on the first stage; the final norm
    and the head (or the tied embedding) on the last."""
    n_layers = len(pp_params["stacked.ln1.scale"])
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    out = {k: v[index * per:(index + 1) * per]
           for k, v in pp_params.items() if k.startswith("stacked.")}
    first, last = index == 0, index == n_stages - 1
    for k, v in pp_params.items():
        if ((k == "embed.table" and (first or (last and "lm_head" not in
                                                pp_params)))
                or (last and k in ("final_norm.scale", "lm_head"))):
            out[k] = v
    return out


class GPTStage:
    """One stage of the GPT as an MPMD pipeline stage: a ``StackedGPT`` of
    this stage's weights (``stage_params``) on ``device`` (None: the card).
    ``apply`` takes the token ids [B, S] on the ``first`` stage, else
    the hop of the stage before, runs the layers (``_layer``, no tensor
    parallelism) and returns the hop of its output: the residual stream,
    or on the last stage the logits [B, S, vocab] in ``cfg.dtype``. The
    weights are fp32 masters, cast to ``cfg.dtype`` per layer as the
    pipeline loss casts them."""

    def __init__(self, cfg: GPTConfig, params: Mapping[str, Any], *,
                 first: bool, last: bool, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.first, self.last = first, last
        tensors = {k: (v.detach() if torch.is_tensor(v)
                       else torch.from_numpy(np.array(v))).to(
                           self.device, torch.float32, copy=True)
                   for k, v in params.items()}
        self.model = StackedGPT(cfg, tensors)
        self.model.requires_grad_(False)
        self._layers = list(zip(*[
            self.model.get_parameter("stacked." + n).unbind(0)
            for n in _LAYER]))

    @torch.no_grad()
    def apply(self, x):
        cfg = self.cfg
        if self.first:
            tokens = torch.as_tensor(np.asarray(x), device=self.device)
            h = self.model.embed.table.to(cfg.dtype)[tokens]
        else:
            h = from_hop(x, self.device)
        b, s, _ = h.shape
        positions = torch.arange(s, device=self.device)[None, :].expand(b, s)
        for weights in self._layers:
            h = _layer(h, positions, cfg, None, *weights)
        if self.last:
            h = _rmsnorm(h, self.model.final_norm.scale, cfg.rmsnorm_eps)
            if cfg.tie_embeddings:
                h = h @ self.model.embed.table.to(cfg.dtype).t()
            else:
                h = h @ self.model.lm_head.to(cfg.dtype)
        return to_hop(h)

    def where(self) -> dict:
        """This stage's process, device and card (UUID, or None)."""
        return device_where(self.device)
