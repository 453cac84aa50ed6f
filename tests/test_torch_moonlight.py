"""The port's DeepSeek-V3 block (``GPTConfig(kv_lora_rank=..., router=
"sigmoid", held_experts=...)``, Moonlight-16B-A3B's) against the plain
reference in ``torch_moonlight_reference.py``, on the CPU at a small size
with Moonlight's shape ratios: hidden 64, 4 heads of q and k 24 (16 + 8
rotated) and v 16, a latent of 32, 16 experts of 32 of which 4 are held,
top 4, 2 shared experts, one dense layer and two expert layers; seeded
random weights, the port's own draw copied into the reference.

Tolerances, fp32 against fp32 (the two sum in other orders, a few ulps a
product, grown over three layers and their backward; they read 2e-7
(MLA's output), 8e-8 (the loss) and 2e-6 (the worst gradient leaf)):
block outputs 1e-5 of the output's largest magnitude; the loss 5e-7
relative; each gradient leaf 1e-4 of its largest magnitude. The port in
bf16 misses them (``test_bf16_products_fail_the_tolerances``: the loss
by 7x, the gradients by 1000x): bf16 keeps 8 bits, 4e-3 relative a
product. Routing is compared for
equality: with random fp32 inputs no two scores of a token lie within the
two sides' rounding of each other."""

import dataclasses
import time

import pytest
import torch

import torch_moonlight_reference as ref
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel.mesh import Axis
from ray_tpu_torch.util import spans

OUT_TOL = 1e-5
LOSS_RTOL = 5e-7
GRAD_RTOL = 1e-4

C = ref.Widths(vocab=256, d=64, layers=3, heads=4, d_ff=128, nope=16,
               rope=8, v=16, latent=32, experts=16, top_k=4, expert_ff=32,
               shared=2, first_dense=1, held=(4, 4), scale=2.446, alpha=0.01,
               theta=50000.0)


def port_cfg(c=C, dtype=torch.float32, remat="full", held=None, rate=0.0):
    return tgpt.GPTConfig(
        vocab_size=c.vocab, d_model=c.d, n_layers=c.layers, n_heads=c.heads,
        d_ff=c.d_ff, max_seq=64, dtype=dtype, rope_theta=c.theta,
        rmsnorm_eps=c.eps, remat_policy=remat, attention="flash",
        n_experts=c.experts, expert_top_k=c.top_k, router="sigmoid",
        routed_scale=c.scale, seq_aux_alpha=c.alpha,
        held_experts=held or c.held, moe_d_ff=c.expert_ff,
        n_shared_experts=c.shared, first_dense_layers=c.first_dense,
        kv_lora_rank=c.latent, qk_nope_head_dim=c.nope,
        qk_rope_head_dim=c.rope, v_head_dim=c.v, bias_update_rate=rate)


def model(cfg=None, seed=0, bias=True):
    """The port's model of ``cfg`` drawn from ``seed``, norm scales drawn
    away from 1 and, with ``bias``, every selection bias nonzero (wide
    enough to change some choices)."""
    gen = torch.Generator().manual_seed(seed)
    m = tgpt.gpt_init(cfg or port_cfg(), device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("scale"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
        if bias:
            for name, b in m.named_buffers():
                if name.endswith(".bias"):
                    b.copy_(0.2 * torch.randn(b.shape, generator=gen))
    return m


def weights(m):
    return {n: p.detach().clone().requires_grad_()
            for n, p in m.named_parameters()}


def biases(m):
    return {i: layer.moe.bias for i, layer in enumerate(m.layers)
            if hasattr(layer, "moe")}


def under(w, i):
    p = f"layers.{i}."
    return {n[len(p):]: t for n, t in w.items() if n.startswith(p)}


def hidden(seed, b=2, s=32, d=C.d):
    return torch.randn(b, s, d, generator=torch.Generator().manual_seed(seed))


def tokens(seed, b=2, s=32):
    return torch.randint(0, C.vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(seed))


def positions(b=2, s=32):
    return torch.arange(s)[None, :].expand(b, s)


def close(got, want, tol=OUT_TOL):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_the_leaves_are_moonlights():
    """Layer 0 dense, the rest experts; MLA's leaves, the held experts'
    weights only, the router over all of them, the shared experts; the
    selection bias a buffer, not a parameter."""
    m = model()
    names = dict((n, tuple(p.shape)) for n, p in m.named_parameters())
    assert names["layers.0.attn.wq"] == (64, 4 * 24)
    assert names["layers.0.attn.wkv_a"] == (64, 32 + 8)
    assert names["layers.0.attn.kv_norm.scale"] == (32,)
    assert names["layers.0.attn.wkv_b"] == (32, 4 * 32)
    assert names["layers.0.attn.wo"] == (4 * 16, 64)
    assert names["layers.0.mlp.w_up"] == (64, 128)
    assert not any(n.startswith("layers.0.moe") for n in names)
    assert names["layers.1.moe.router"] == (64, 16)
    assert names["layers.1.moe.w_gate"] == (4, 64, 32)
    assert names["layers.2.moe.w_down"] == (4, 32, 64)
    assert names["layers.1.moe.shared.w_up"] == (64, 64)
    assert [n for n, _ in m.named_buffers()] == ["layers.1.moe.bias",
                                                  "layers.2.moe.bias"]


def test_mla_block_matches_reference():
    m = model()
    x = hidden(1)
    with torch.no_grad():
        got = tgpt._mla_block(m.layers[1], x, m.cfg, positions())
        want = ref.mla(C, under(weights(m), 1), x)
    assert close(got, want)


def test_sigmoid_routing_with_a_bias_matches_reference():
    """The chosen experts (by scores plus the bias), their weights (the
    unbiased scores, renormalised and scaled) and the scores."""
    m = model()
    moe = m.layers[1].moe
    assert moe.bias.abs().min() > 0
    x = hidden(2)
    with torch.no_grad():
        scores, w, idx = tgpt._route(moe, x, m.cfg)
        r_scores, r_w, r_idx = ref.route(C, moe.router, moe.bias, x)
        plain = torch.topk(scores, C.top_k, dim=-1).indices
    assert torch.equal(idx, r_idx)
    assert close(w, r_w) and close(scores, r_scores)
    # The bias moved some choices, and the weights carry no bias.
    assert not torch.equal(idx.sort(-1).values, plain.sort(-1).values)
    picked = scores.gather(-1, idx)
    assert close(w, C.scale * picked / picked.sum(-1, keepdim=True))
    assert torch.allclose(w.sum(-1), torch.full(w.shape[:-1], C.scale))


def test_expert_layer_and_balance_term_match_reference():
    m = model()
    x = hidden(3)
    with torch.no_grad():
        y, stats = tgpt._sparse_moe_block(m.layers[1], x, m.cfg)
        aux = tgpt._seq_aux(stats[None], x.shape[1], C.top_k)
        r_y, r_aux = ref.experts(C, under(weights(m), 1), m.layers[1].moe.bias,
                                 x)
    assert close(y, r_y)
    assert abs(float(aux) - float(r_aux)) <= LOSS_RTOL * abs(float(r_aux))


def _loss_and_grads(cfg, toks, seed=0):
    m = model(cfg, seed)
    loss = tgpt.gpt_loss(m, {"tokens": toks})
    loss.backward()
    return m, loss, {n: p.grad for n, p in m.named_parameters()}


def _reference(m, toks):
    w = weights(m)
    loss, aux = ref.loss(C, w, biases(m), toks)
    loss.backward()
    return loss, aux, {n: t.grad for n, t in w.items()}


def _gaps(m, loss, grads, toks):
    r_loss, _, r_grads = _reference(m, toks)
    loss_gap = abs(float(loss.detach()) - float(r_loss.detach())) / float(
        r_loss.detach())
    grad_gap = max(float((grads[n].float() - g).abs().max())
                   / float(g.abs().max()) for n, g in r_grads.items())
    return loss_gap, grad_gap, r_grads


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_gradient_match_reference(remat):
    """The loss with its balance term (alpha 0.01 here, so that the term
    shows in the loss and the router's gradient) and every leaf's
    gradient, under remat ``full`` (the recompute routes again) and
    ``none``."""
    toks = tokens(4)
    m, loss, grads = _loss_and_grads(port_cfg(remat=remat), toks)
    loss_gap, grad_gap, r_grads = _gaps(m, loss, grads, toks)
    assert set(r_grads) == set(grads)
    assert all(float(g.abs().max()) > 0 for g in r_grads.values())
    assert loss_gap <= LOSS_RTOL, loss_gap
    assert grad_gap <= GRAD_RTOL, grad_gap


def test_the_balance_term_is_in_the_loss():
    toks = tokens(4)
    m = model()
    with torch.no_grad():
        _, aux = tgpt.gpt_backbone(m, toks[:, :-1])
        _, r_aux = ref.loss(C, weights(m), biases(m), toks)
    assert float(aux) > 0
    assert abs(float(aux) - float(r_aux)) <= LOSS_RTOL * float(r_aux)


def test_bf16_products_fail_the_tolerances():
    """The same comparison with the port computing in bf16, as the card
    does: the loss and the gradients miss their fp32 tolerances by far."""
    toks = tokens(4)
    m, loss, grads = _loss_and_grads(port_cfg(dtype=torch.bfloat16), toks)
    loss_gap, grad_gap, _ = _gaps(m, loss, grads, toks)
    assert loss_gap > 5 * LOSS_RTOL, loss_gap
    assert grad_gap > 10 * GRAD_RTOL, grad_gap


class _ExpertSplit:
    """A placement that splits the experts over an 'expert' axis of
    ``size``, this model being part ``index`` (one process: the axis has
    no group, and the parts' sum is taken by the test)."""

    def __init__(self, index, size):
        self.part = Axis(size=size, index=index)
        self.mesh = self

    def split_dim(self, name, axis):
        return 0 if axis == "expert" and ".moe.w_" in name else None

    def axis(self, axes):
        return self.part


@pytest.mark.parametrize("by", ["held_experts", "placement"])
def test_the_shares_add_up_to_the_uncut_layer(by):
    """The 16 experts cut in 4 shares of 4: what the shares compute, the
    shared experts counted once, adds up to the uncut reference's layer.
    A share is told its experts by ``held_experts``, or by its part of an
    'expert' axis."""
    whole = model(port_cfg(held=(0, C.experts)))
    x = hidden(5)
    w = under(weights(whole), 1)
    with torch.no_grad():
        want, _ = ref.experts(C, w, whole.layers[1].moe.bias, x,
                              held=(0, C.experts))
        shared = ref.swiglu(x, w["moe.shared.w_gate"], w["moe.shared.w_up"],
                            w["moe.shared.w_down"])
        total = torch.zeros_like(x)
        for j in range(4):
            held = (4 * j, 4) if by == "held_experts" else (0, 4)
            part = model(port_cfg(held=held))
            part.load_state_dict({
                n: t[4 * j:4 * j + 4] if ".moe.w_" in n else t
                for n, t in whole.state_dict().items()})
            placement = _ExpertSplit(j, 4) if by == "placement" else None
            y, _ = tgpt._sparse_moe_block(part.layers[1], x, part.cfg,
                                          placement)
            total += y - shared
        total += shared
    assert close(total, want)
    # Each share alone is not the whole.
    assert not close(y, want, 1e-2)


def _recorded_routing(monkeypatch):
    seen = []
    route = tgpt._route

    def record(moe, x, cfg):
        out = route(moe, x, cfg)
        seen.append(out[2].detach().clone())
        return out

    monkeypatch.setattr(tgpt, "_route", record)
    return seen


def _held_rows(idx, cfg):
    first, count = cfg.held
    return int(((idx >= first) & (idx < first + count)).sum())


def test_the_recompute_routes_the_same_rows(monkeypatch):
    """Under remat ``full`` the backward runs each expert layer again; it
    chooses the same experts for every token, and the counters count both
    passes' rows."""
    seen = _recorded_routing(monkeypatch)
    cfg = port_cfg(remat="full")
    m = model(cfg)
    before = dataclasses.replace(tgpt.EXPERTS)
    loss = tgpt.gpt_loss(m, {"tokens": tokens(6)})
    assert len(seen) == 2
    loss.backward()
    assert len(seen) == 4
    # Forward: layers 1, 2; the backward's recompute: 2, 1.
    assert torch.equal(seen[0], seen[3]) and torch.equal(seen[1], seen[2])
    assert tgpt.EXPERTS.calls - before.calls == 4
    assert tgpt.EXPERTS.rows - before.rows == sum(
        _held_rows(i, cfg) for i in seen)


def test_a_profiled_step_records_the_spans_and_counters(monkeypatch):
    """A train step under the profiler records ``mla`` in every layer and
    ``experts`` in every expert layer, in the forward and in remat's
    recompute, inside ``step``; ``experts.rows`` is the rows that the
    routing sent to held experts."""
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.train.train_step import (AdamW, init_train_state,
                                                make_train_step)
    seen = _recorded_routing(monkeypatch)
    cfg = port_cfg(remat="full")
    opt = AdamW(1e-3)
    state = init_train_state(lambda: model(cfg), opt)
    step = make_train_step(tgpt.gpt_loss, opt)
    before = dataclasses.replace(tgpt.EXPERTS)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        state, _ = step(state, {"tokens": tokens(7)})
    names = [s.name for s in spans.recorded(t0)]
    assert names.count("mla") == 2 * C.layers
    assert names.count("experts") == 2 * (C.layers - C.first_dense)
    assert tgpt.EXPERTS.calls - before.calls == names.count("experts")
    assert tgpt.EXPERTS.rows - before.rows == sum(
        _held_rows(i, cfg) for i in seen) > 0
    by_id = {s.id: s for s in spans.recorded(t0)}
    for s in spans.recorded(t0):
        if s.name in ("mla", "experts"):
            assert by_id[s.parent].name in ("forward", "backward"), s.name


RATE = 0.05     # wide enough to move some choices at this size


def _trained(cfg, batches, accum_steps=0):
    from ray_tpu_torch.train.train_step import (AdamW, init_train_state,
                                                make_train_step)
    opt = AdamW(1e-3)
    state = init_train_state(lambda: model(cfg), opt)
    step = make_train_step(tgpt.gpt_loss, opt, accum_steps=accum_steps)
    out = []
    for batch in batches:
        state, metrics = step(state, {"tokens": batch})
        out.append(float(metrics["loss"]))
    return state.params, out


@pytest.mark.parametrize("accum_steps", [0, 2])
def test_a_train_step_moves_the_bias_toward_balance(accum_steps):
    """After a train step each selection bias has moved by the rate, up
    where its expert's load in the step was below the mean and down where
    above, as the reference moves it from the same weights, bias and
    batch; the microbatches of an accumulated step count together. The
    next step routes by the moved bias: its loss is the reference's with
    the step's weights and the moved biases."""
    toks = tokens(8)
    first = model(port_cfg(rate=RATE))
    want = {i: ref.moved(b, load, RATE) for (i, b), load in zip(
        biases(first).items(),
        ref.loads(C, weights(first), biases(first), toks).values())}
    batches = [toks, tokens(9)]
    if accum_steps:
        batches = [t.view(2, 1, -1) for t in batches]
    m, losses = _trained(port_cfg(rate=RATE), batches, accum_steps)
    # After the second step; redo the first alone for its bias.
    m1, _ = _trained(port_cfg(rate=RATE), batches[:1], accum_steps)
    got = biases(m1)
    assert got.keys() == want.keys()
    for i in want:
        assert torch.equal(got[i], want[i]), i
        assert not torch.equal(got[i], biases(first)[i])
        assert not m1.layers[i].moe.load.any()
    with torch.no_grad():
        r_loss, _ = ref.loss(C, weights(m1), got, tokens(9))
    assert abs(losses[1] - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    # The second step moved them again.
    assert not torch.equal(biases(m)[1], got[1])


def test_the_bias_stays_without_a_rate_and_outside_a_step():
    """Without a rate the bias is a buffer that no step moves; with one,
    a pass without gradients (evaluation) counts no load."""
    still, _ = _trained(port_cfg(), [tokens(8)])
    assert all(torch.equal(b, biases(model())[i])
               for i, b in biases(still).items())
    assert [n for n, _ in still.named_buffers()] == ["layers.1.moe.bias",
                                                      "layers.2.moe.bias"]
    m = model(port_cfg(rate=RATE))
    with torch.no_grad():
        tgpt.gpt_loss(m, {"tokens": tokens(8)})
    assert not any(layer.moe.load.any() for layer in m.layers[1:])
    with pytest.raises(ValueError, match="bias_update_rate"):
        tgpt.gpt_init(dataclasses.replace(port_cfg(rate=RATE),
                                          router="softmax"), device="cpu")


def test_softmax_routing_takes_the_sparse_dispatch_where_experts_are_held(
        monkeypatch):
    """Softmax routing with every expert held runs the sparse dispatch,
    which computes what the dense one does: the same output and the same
    Switch statistics; without held or shared experts it keeps the dense
    dispatch (the JAX model's MoE)."""
    dense_cfg = tgpt.GPTConfig(
        vocab_size=C.vocab, d_model=C.d, n_layers=2, n_heads=C.heads,
        d_ff=C.expert_ff, max_seq=64, dtype=torch.float32, n_experts=8,
        expert_top_k=2, attention="reference")
    held_cfg = dataclasses.replace(dense_cfg, held_experts=(0, 8))
    assert dense_cfg.dense_dispatch and not held_cfg.dense_dispatch
    m = tgpt.gpt_init(held_cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    x = hidden(10)
    with torch.no_grad():
        y, stats = tgpt._sparse_moe_block(m.layers[0], x, held_cfg)
        want, want_stats = tgpt._moe_block(m.layers[0], x, dense_cfg)
    assert close(y, want)
    assert torch.equal(stats[0], want_stats[0])
    assert close(stats[1], want_stats[1])
    seen = []
    sparse = tgpt._sparse_moe_block

    def record(*args):
        seen.append(1)
        return sparse(*args)

    monkeypatch.setattr(tgpt, "_sparse_moe_block", record)
    tgpt.gpt_loss(m, {"tokens": tokens(11)[:, :17]})
    assert len(seen) == 2
