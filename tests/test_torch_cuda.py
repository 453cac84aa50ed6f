"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no card is present (they need nvcc and a
GPU). On the card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Tolerances are chip_smoke.py's (its ``check_case``): element by element,
|kernel - plain| <= rtol (|plain| + |W||X|), with W X the product that
defines the output, rtol 1e-5 in fp32, 2^-7 (one bf16 ulp) in bf16 and
2^-10 (one fp16 ulp) in fp16; lse within 1e-4 absolute.
"""

import dataclasses

import numpy as np
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
    # head dims padded on the card: 80 to 128 (bf16: the tensor cores),
    # 256 (CUDA cores, 32-row tiles in K2 and K3), 77 (tensor cores,
    # element-wise loads and stores); fp16 on the CUDA cores
    (1024, 1024, 80, torch.bfloat16, True, 128, 128),
    (160, 96, 80, torch.bfloat16, True, 32, 32),
    (96, 224, 77, torch.bfloat16, False, 32, 32),
    (160, 96, 256, torch.bfloat16, True, 32, 32),
    (64, 32, 256, torch.float32, True, 64, 32),      # masked rows: mean V
    (96, 224, 80, torch.float32, False, 32, 32),
    (128, 128, 64, torch.float16, True, 64, 64),
    (96, 32, 80, torch.float16, True, 32, 32),       # rows with no keys
])
def test_kernels_match_plain(card, sq, sk, d, dtype, causal, bq, bk):
    res = chip_smoke.check_case(3, sq, sk, d, dtype, causal, bq, bk, card)
    assert all(ok for _, _, ok, _ in res.values()), res


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (32, torch.float32)])
def test_kernels_at_bh_above_65535(card, d, dtype):
    """B·H 70000, more than blockIdx.y could hold: each kernel launches
    once and agrees with its plain version."""
    before = {n: k.launches for n, k in A.KERNELS.items()}
    res = chip_smoke.check_case(70000, 16, 16, d, dtype, True, 16, 16, card)
    assert all(ok for _, _, ok, _ in res.values()), res
    assert {n: k.launches - before[n] for n, k in A.KERNELS.items()} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
def test_cuda_tensor_launches_kernel(card):
    before = A.KERNELS["flash_fwd"].launches
    q = torch.randn((1, 2, 64, 32), generator=card, device="cuda")
    A.flash_attention(q, q, q, block_q=64, block_k=64)
    assert A.KERNELS["flash_fwd"].launches == before + 1


@pytest.mark.cuda
def test_unsupported_input_raises(card):
    """Head dims above 256 raise (ROADMAP R-13); JAX's kernel takes them,
    and so do the plain versions on the CPU."""
    q = torch.randn((2, 64, 320), generator=card, device="cuda")
    with pytest.raises(ValueError, match="limit of 256"):
        A.flash_fwd(q, q, q, causal=True, sm_scale=1.0, block_q=64,
                    block_k=64)
    c = q.cpu()
    o, _ = A.flash_fwd(c, c, c, causal=True, sm_scale=1.0, block_q=64,
                       block_k=64)
    assert o.shape == c.shape and torch.isfinite(o).all()


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


@pytest.mark.cuda
@pytest.mark.timeout(600)
@pytest.mark.parametrize("data,fsdp", [(1, 2), (2, 1)])
def test_mp_check_gang_on_cards_matches_one_process(card, data, fsdp):
    """ray_tpu_torch/parallel/mp_check.py's gang as its defaults run it:
    two NCCL processes, rank r on cuda:r, over data x fsdp, held to the
    whole batch in this one process on one card within 1e-5, as JAX holds
    its gang. In fp32 (the CUDA-core kernels), the port's own init: in
    bf16 each rank rounds its own rows' weight gradients
    (tests/test_torch_mp_check.py). Needs two cards or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from ray_tpu_torch.parallel import mp_check
    baseline = mp_check.step_loss(1, 1, dtype=torch.float32)
    gang = mp_check.run_gang_subprocesses(2, 1, data, fsdp, dtype="float32")
    print(f"\n[mp_check] data={data} fsdp={fsdp}: gang {gang}, one "
          f"process {baseline}")
    assert len(gang) == 2 and gang[0] == gang[1]
    assert all(abs(x - baseline) < 1e-5 for x in gang), (gang, baseline)

@pytest.mark.cuda
@pytest.mark.timeout(300)
def test_collective_across_cards(card, tmp_path):
    """ray_tpu_torch.util.collective on a NCCL group of four ranks, one per
    card: tests/test_torch_collective.py's three cases (6 reducescatter
    rows: parts of 2, 2, 1, 1), checked against numpy, and the point-to-
    point links each rank made: none before its sends, then exactly those
    it used. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import test_torch_collective as C
    from test_torch_strategies import launch
    run = dict(kind="collective", tag="", backend="nccl", rs_rows=6)
    outs = launch(tmp_path, [run], {}, world=4, device="cuda", timeout=240)
    C.test_collective_ops((4, outs))
    C.test_symmetric_send_recv((4, outs))
    C.test_pair_links_made_only_for_sends((4, outs))
    C.test_allreduce_pytree((4, outs))


# (tag, strategy, mesh over four cards, GPTConfig fields over gpt2_small);
# the pipeline presets run PP_MICROBATCHES microbatches.
ACROSS = [
    ("fsdp", "fsdp", dict(fsdp=4), {}),
    ("tp", "tp", dict(tensor=4), {}),
    ("tp_fsdp", "tp_fsdp", dict(fsdp=2, tensor=2), {}),
    ("tp_moe", "tp", dict(expert=4), dict(n_experts=4)),
    ("sp_ep", "sp_ep", dict(sequence=2, expert=2),
     dict(attention="ring", n_experts=4)),
    ("pp", "pp", dict(pipeline=4), {}),
    ("pp_tp", "pp_tp", dict(pipeline=2, tensor=2), {}),
]
PP_MICROBATCHES = 4


def _routing(ranks, tag, n_layers):
    """{layer: [B, S, k]} of step 0's forward, assembled from the ranks'
    rows (data x fsdp coordinate) and positions (sequence coordinate)."""
    blocks = {}
    for out in ranks:
        c = out[tag + "coord"]
        blocks.setdefault((int(c[0]) * 1000 + int(c[1]), int(c[4])), out)
    rows = sorted({r for r, _ in blocks})
    seqs = sorted({s for _, s in blocks})
    return {i: torch.from_numpy(np.concatenate([np.concatenate(
        [blocks[(r, s)][f"{tag}routing{i}"] for s in seqs], axis=1)
        for r in rows], axis=0)).cuda() for i in range(n_layers)}


def _median_ms(times) -> float:
    return float(np.median(times[1:]))


@pytest.mark.cuda
@pytest.mark.timeout(1000)
def test_strategies_across_cards_match_one_card(card, tmp_path):
    """GPT-2 small at full width (bf16, batch 8, seq 1024, remat full), one
    NCCL rank per card on four cards, under fsdp (fsdp=4), tp (tensor=4),
    tp_fsdp (2x2), tp with MoE (4 experts, expert=4), the dry run's
    sp_ep (sequence=2 x expert=2, ring attention, MoE 4 experts), pp
    (pipeline=4: 3 layers a stage) and pp_tp (pipeline=2 x tensor=2), the
    pipeline presets with 4 microbatches of 2 rows, each against the same
    config on one card through the same code in a world of one: step 0
    within chip_smoke.py's gate (loss 1e-4, grad norm 2e-3 relative; for
    MoE the one-card step replays the four cards' routing, as chip_smoke's
    phase (i) does), the same loss on every rank, losses falling over 3
    more steps, and per rank 2n/n/n launches of K1-K3 a step, n = L (M L
    / S for the pipeline: M microbatches, S stages; none under ring
    attention). The tp_fsdp state, saved by train.checkpoint after its
    steps, loads whole into a one-card state equal, bit for bit, to the
    final parameters gathered from the four ranks. Prints each side's step
    ms, profiled device ms (NCCL's kernels apart: they overlap the compute
    and spin while they wait) and peak memory. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import subprocess

    import torch_dp_worker as W
    from test_torch_strategies import launch

    from ray_tpu_torch.models import GPTConfig
    runs = [dict(tag=f"{tag}/", kind="card", preset="gpt2_small",
                 dtype="bfloat16", cfg=cfg, strategy=strategy, mesh=mesh,
                 batch=8, seq=1024, steps=4)
            for tag, strategy, mesh, cfg in ACROSS]
    for run in runs:
        if run["strategy"].startswith("pp"):
            run["microbatches"] = PP_MICROBATCHES
        if run["strategy"] == "tp_fsdp":
            run.update(save=str(tmp_path / "tp_fsdp_ckpt"),
                       gathered=str(tmp_path / "tp_fsdp_gathered.npz"))
    ranks = launch(tmp_path, runs, {}, world=4, device="cuda", timeout=600)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"\n[across] {len(smi)} cards: {smi}")
    failures = []
    for run in runs:
        tag = run["tag"]
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), **run["cfg"])
        one = {}
        W.card(run, ["cuda:0"], one, world_of_one=True)
        n = 0 if cfg.attention == "ring" else cfg.n_layers
        if run.get("microbatches"):
            n = run["microbatches"] * n // run["mesh"]["pipeline"]
        for r, out in enumerate(ranks):
            print(f"[across] {tag} rank {r}: losses "
                  f"{np.round(out[tag + 'loss'], 5).tolist()}, step "
                  f"{_median_ms(out[tag + 'step_ms']):.1f} ms, device "
                  f"{float(out[tag + 'device_ms']):.2f} ms (NCCL kernels "
                  f"{float(out[tag + 'nccl_ms']):.2f} ms apart), peak "
                  f"{float(out[tag + 'peak_gb']):.2f} GB, K1-K3 launches "
                  f"per step {out[tag + 'launches'][0].tolist()}")
        print(f"[across] {tag} one card: losses "
              f"{np.round(one[tag + 'loss'], 5).tolist()}, step "
              f"{_median_ms(one[tag + 'step_ms']):.1f} ms, device "
              f"{float(one[tag + 'device_ms']):.2f} ms, peak "
              f"{float(one[tag + 'peak_gb']):.2f} GB, K1-K3 launches per "
              f"step {one[tag + 'launches'][0].tolist()}")
        out0 = ranks[0]
        for side, out in (("rank 0", out0), ("one card", one)):
            print(f"[across] {tag} {side} top device ops: "
                  f"{out[tag + 'top'].tolist()}")
        loss, norm = (float(out0[tag + "loss"][0]),
                      float(out0[tag + "grad_norm"][0]))
        ref = (float(one[tag + "loss"][0]), float(one[tag + "grad_norm"][0]))
        if cfg.n_experts:
            chip_smoke._gate("across", loss, norm, ref,
                             f"{tag} vs one card, routing free (printed)")
            _, model, batch = W.card_model(run)
            ref = chip_smoke._step0(
                dataclasses.replace(cfg, dtype=torch.bfloat16),
                model.state_dict(), batch,
                replay=_routing(ranks, tag, cfg.n_layers),
                strategy=W._strategy(run["strategy"]))
            del model
        if not chip_smoke._gate("across", loss, norm, ref,
                                f"{tag} vs one card"):
            failures.append(f"{tag} step 0")
        for r, out in enumerate(ranks):
            ls = out[tag + "loss"]
            if not (np.all(np.isfinite(ls)) and np.all(np.diff(ls) < 0)):
                failures.append(f"{tag} rank {r} losses {ls.tolist()}")
            if ls.tolist() != out0[tag + "loss"].tolist():
                failures.append(f"{tag} rank {r} loss differs from rank 0")
            want = [[2 * n, n, n]] * len(ls)
            if out[tag + "launches"].tolist() != want:
                failures.append(f"{tag} rank {r} launches "
                                f"{out[tag + 'launches'].tolist()}")
        torch.cuda.empty_cache()
    failures += _restore_whole_on_one_card(runs)
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.timeout(900)
def test_trainer_gang_across_cards_matches_one_card(tmp_path, monkeypatch):
    """The port's Trainer with runtime=ray_tpu on four cards: four ray_tpu
    actors (ScalingConfig(num_workers=4, use_gpu=True): one accelerator
    slot each), the NCCL group of CudaBackendConfig, each worker on
    cuda:<local rank>, running chip_smoke.harness_loop (phase (p)'s loop:
    GPT-2 small, bf16, batch 8, seq 1024, AdamW(3e-4), a sharded
    checkpoint after every second step) under MeshConfig(fsdp=4) for 6
    steps. Held: four distinct pids and cards; 24/12/12 launches of K1-K3
    per rank and step; rank 0's step 0 within chip_smoke's gate (loss 1e-4,
    grad norm 2e-3 relative) of the same loop on one card (dp, a world of
    one, run by the in-process Trainer after the gang); and a run in which
    rank 2 raises before step 3 restarts the gang from the checkpoint after
    step 1 and ends with the final loss and TrainState of the uninterrupted
    four-card run, bit for bit. This process touches CUDA only after the
    gangs have run: the workers are forked from ray_tpu's fork server, not
    from here. Prints each rank's step ms, peak memory and the restart
    time. Needs four cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import statistics
    import subprocess

    import ray_tpu

    from ray_tpu_torch.ops import _build
    _build.build_all()          # once here, not in each worker
    # The runtime's own jax import stays off the cards.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    root = str(tmp_path)
    cfg = dict(steps=6, every=2, fail_at=3, fail_rank=2, mesh={"fsdp": 4},
               strategy="fsdp")
    ray_tpu.init(num_tpus=4)
    try:
        gang = dict(workers=4, runtime=ray_tpu)
        _, ref_dir = chip_smoke.harness_fit(root, "U", **gang,
                                            **dict(cfg, fail_at=None))
        run, run_dir = chip_smoke.harness_fit(root, "F", failures=1, **gang,
                                              **cfg)
    finally:
        ray_tpu.shutdown()
    _, one_dir = chip_smoke.harness_fit(
        root, "one", **dict(cfg, fail_at=None, steps=4, every=4,
                            mesh={"data": 1}, strategy="dp"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"\n[gang] {len(smi)} cards: {smi}")
    failures = []
    want = [24, 12, 12]
    for tag, d in (("U", ref_dir), ("F", run_dir)):
        starts = []
        for r in range(4):
            ev = chip_smoke.harness_events(d, r)
            steps = [e for e in ev if e["event"] == "step"]
            starts += [e for e in ev if e["event"] == "start"]
            peaks = [round(e["peak_gb"], 2) for e in ev
                     if e["event"] in ("end", "raise")]
            print(f"[gang] {tag} rank {r}: losses "
                  f"{[round(e['loss'], 5) for e in steps]}, step "
                  f"{statistics.median(e['ms'] for e in steps[1:]):.1f} ms "
                  f"(median after the first; {[round(e['ms'], 1) for e in steps]}),"
                  f" peak {peaks} GB")
            bad = [e["step"] for e in steps
                   if list(e["launches"].values()) != want]
            if bad:
                failures.append(f"{tag} rank {r} launches at steps {bad}")
        first = [s for s in starts if s["attempt"] == 1]
        print(f"[gang] {tag} workers: pids {[s['pid'] for s in first]}, "
              f"cards {[s['card'] for s in first]}, uuids "
              f"{[s['uuid'][-12:] for s in first]}")
        for key in ("pid", "card", "uuid"):
            if len({s[key] for s in first}) != 4:
                failures.append(f"{tag}: the workers share a {key}")
    ev2 = chip_smoke.harness_events(run_dir, 2)
    raised = next(e for e in ev2 if e["event"] == "raise")
    resumed = next(e for e in ev2 if e["event"] == "step" and
                   e["attempt"] == 2)
    print(f"[gang] F: rank 2 raised before step {raised['step']}; restart "
          f"{resumed['t'] - raised['t']:.2f} s to the first step of attempt 2 "
          f"(step {resumed['step']}); error {run.error}")
    one = [e for e in chip_smoke.harness_events(one_dir)
           if e["event"] == "step"]
    print(f"[gang] one card (dp): losses {[round(e['loss'], 5) for e in one]},"
          f" step {statistics.median(e['ms'] for e in one[1:]):.1f} ms")
    step0 = next(e for e in chip_smoke.harness_events(ref_dir, 0)
                 if e["event"] == "step")
    if not chip_smoke._gate("gang", step0["loss"], step0["grad_norm"],
                            (one[0]["loss"], one[0]["grad_norm"]),
                            "rank 0 (fsdp=4) vs one card"):
        failures.append("step 0 differs from one card")
    ok, reading, _ = chip_smoke.harness_gate(run_dir, ref_dir)
    print(f"[gang] restarted run vs uninterrupted: {reading}")
    if not ok or run.error is not None:
        failures.append(f"restart: {reading}")
    assert not failures, failures


def _restore_whole_on_one_card(runs) -> list:
    """The tp_fsdp checkpoint loaded into a one-card state: every
    parameter against the four ranks' gathered final ones, bit for bit.
    -> failures."""
    import torch_dp_worker as W

    from ray_tpu_torch.models import gpt_init
    from ray_tpu_torch.train import AdamW, init_train_state, load_pytree
    run = next(r for r in runs if r.get("save"))
    cfg, _, _ = W.card_model(run)
    state = init_train_state(lambda: gpt_init(cfg, device="cuda"),
                             AdamW(3e-4))
    state = load_pytree(run["save"], state=state)
    gathered = np.load(run["gathered"])
    differ = [n for n, p in state.params.named_parameters()
              if not np.array_equal(p.detach().cpu().numpy(), gathered[n])]
    print(f"[across] tp_fsdp checkpoint at step {state.step}, loaded whole "
          f"on one card: {len(gathered.files)} parameters, differing from "
          f"the gathered ones: {differ or 'none'}")
    return [f"tp_fsdp restore differs: {differ}"] if differ else []


def _rl_case(name):
    """A learner of RLlib's continuous and offline slice at the JAX
    algorithms' widths, and a batch from a seed: (make(device), batch,
    loss key, largest lr, whether the update takes injected draws)."""
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.algorithms import bc, cql, marwil, sac, td3
    rng = np.random.default_rng(0)
    n = chip_smoke.RL_OFF["batch"]
    hidden = chip_smoke.RL_OFF["hidden"]
    if name in ("bc", "marwil"):
        batch = sb.SampleBatch({
            "obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "returns": rng.uniform(0, 40, n).astype(np.float32)})
        cls = bc.BCLearner if name == "bc" else marwil.MARWILLearner
        return (lambda device: cls(4, 2, hidden=hidden, lr=5e-4, seed=0,
                                   device=device), batch, "loss", 5e-4,
                False)
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
             "rewards": rng.standard_normal(n) * 3,
             "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
             "terminateds": rng.random(n) < 0.05}
    if name == "sac_per":
        batch["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    kw = {"sac": {}, "sac_per": {}, "cql": {"num_ood_actions": 4},
          "td3": {}, "ddpg": dict(td3.DDPG_DEFAULTS)}[name]
    cls = {"sac": sac.SACLearner, "sac_per": sac.SACLearner,
           "cql": cql.CQLLearner}.get(name, td3.TD3Learner)
    lr = 1e-3 if cls is td3.TD3Learner else 3e-4
    return (lambda device: cls(3, 1, -2.0, 2.0, hidden=hidden, seed=0,
                               device=device, **kw),
            sb.SampleBatch(batch), "critic_loss", lr, True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sac", "sac_per", "td3", "ddpg", "cql",
                                  "bc", "marwil"])
def test_rl_learner_first_update_matches_cpu(card, name):
    """Each learner of RLlib's second slice: the card's first update
    against the CPU's from the same weights on the same batch with the
    same draws, by chip_smoke's phase-(n) gate (TF32 off)."""
    make, batch, loss_key, lr, noisy = _rl_case(name)
    metrics = chip_smoke._rl_first_update(
        "cuda", name, make(None), make, batch, loss_key, lr,
        noisy=noisy)[0]
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_podracer_run_actors_on_card_machine(monkeypatch):
    """PodracerRun(PodracerConfig(), runtime=ray_tpu) at JAX's default
    widths: the learner a ray_tpu actor on the card (one accelerator slot),
    the two rollout actors on CPUs, a tick_replay compiled DAG between
    them. chip_smoke.PODRACER_TICKS ticks after 5 of warm-up, pipelined
    to the channel depth: the standing invariants over every tick, no
    recovery. This process touches CUDA only after the actors have run;
    then the same config in process (chip_smoke's q1) for ticks/s beside
    it. Prints each member's pid, device and card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import subprocess
    import time

    import ray_tpu
    import ray_tpu._private.object_plane  # noqa: F401
    import ray_tpu.dag.compiled  # noqa: F401
    import ray_tpu.util.scheduling_strategies  # noqa: F401

    from ray_tpu_torch.podracer import PodracerConfig, PodracerRun
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    ticks = chip_smoke.PODRACER_TICKS
    ray_tpu.init(num_cpus=4, num_tpus=1)
    try:
        run = PodracerRun(PodracerConfig(), runtime=ray_tpu)
        try:
            members = run.members
            run.run(5, timeout=120)
            t0 = time.perf_counter()
            outs = run.run(ticks, timeout=120)
            seconds = time.perf_counter() - t0
            stats = run.stats()
            kept = list(run.outputs)
        finally:
            run.teardown()
    finally:
        ray_tpu.shutdown()
    local = chip_smoke._podracer_run(None, ticks)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    steps = sum(o["steps"] for o in outs)
    print(f"\n[podracer] {smi}: members {members}")
    print(f"[podracer] ray_tpu actors: {ticks} ticks in {seconds:.3f} s: "
          f"{ticks / seconds:.1f} ticks/s, {steps / seconds:.0f} env steps/s"
          f" (host clock, window {run.config.channel_depth}); stats {stats}")
    print(f"[podracer] in process (q1): {ticks / local['seconds']:.1f} "
          f"ticks/s, {local['steps'] / local['seconds']:.0f} env steps/s")
    *actors, learner = members
    assert learner["device"].startswith("cuda") and learner["uuid"]
    assert all(a["device"] == "cpu" and a["uuid"] is None for a in actors)
    assert len({m["pid"] for m in members} | {os.getpid()}) == 4
    assert chip_smoke.podracer_invariants(kept, 2) == []
    assert chip_smoke.podracer_invariants(local["outs"], 2) == []
    assert stats["ticks"] == ticks + 5 and stats["recoveries"] == 0
    assert stats["max_inflight"] == run.config.channel_depth


@pytest.mark.cuda
@pytest.mark.timeout(900)
def test_stage_pipeline_across_cards(monkeypatch):
    """chip_smoke's q2 across four cards: GPT-2 small's four GPTStages as
    ray_tpu actors, stage i on cuda:i (one accelerator slot each), chained
    by StagePipeline over ray_tpu's channels (depth 4; a 4 MiB slot holds
    an activation hop, the logits take the store's oversize path). Held:
    four distinct pids and cards; every microbatch's logits equal, bit for
    bit, those of the same layers run whole on one card in this process
    (after the actors: this process touches CUDA only then); K1 launched 3
    times a microbatch on each stage (12 in all; the warm-up microbatch
    counted), K2 and K3 never. Prints ms a microbatch and the bytes a
    hop."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import os
    import subprocess
    import time

    import ray_tpu
    import ray_tpu.dag.compiled  # noqa: F401

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel.pipeline import (GPTStage, StagePipeline,
                                                 stage_params)
    _build.build_all()          # once here, not in each actor
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    cfg, pp, toks = chip_smoke.stage_setup()
    n, m = chip_smoke.STAGES["n"], chip_smoke.STAGES["microbatches"]

    class Stage:
        """A GPTStage on card ``card`` in an actor process, the port
        imported there (ray_tpu ships this class by value)."""

        def __init__(self, cfg, params, first, last, card):
            from ray_tpu_torch.parallel.pipeline import GPTStage
            self._stage = GPTStage(cfg, params, first=first, last=last,
                                   device=f"cuda:{card}")

        def apply(self, x):
            return self._stage.apply(x)

        def where(self):
            return self._stage.where()

        def launches(self):
            from ray_tpu_torch.ops import attention
            return {k: kern.launches for k, kern in attention.KERNELS.items()}

    ray_tpu.init(num_cpus=8, num_tpus=n, object_store_memory=8 << 30)
    try:
        cls = ray_tpu.remote(num_cpus=1, num_gpus=1)(Stage)
        stages = [cls.remote(cfg, {k: v.numpy() for k, v in
                                   stage_params(pp, n, i).items()},
                             i == 0, i == n - 1, i) for i in range(n)]
        where = ray_tpu.get([s.where.remote() for s in stages], timeout=300)
        with StagePipeline(stages, method="apply",
                           channel_depth=chip_smoke.STAGES["channel_depth"],
                           max_message_size=4 << 20,
                           runtime=ray_tpu) as pipe:
            pipe.run(toks[:1], timeout=300)          # warm-up
            t0 = time.perf_counter()
            outs = pipe.run(toks, timeout=300)
            ms = 1e3 * (time.perf_counter() - t0) / m
            stats = pipe.stats()
        # The DAG holds its actors until it is torn down.
        launches = ray_tpu.get([s.launches.remote() for s in stages],
                               timeout=60)
        for s in stages:
            ray_tpu.kill(s)
    finally:
        ray_tpu.shutdown()
    whole = GPTStage(cfg, stage_params(pp, 1, 0), first=True, last=True)
    ref = [whole.apply(t) for t in toks]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    differ = chip_smoke.stage_gate(outs, ref)
    print(f"\n[stages] {len(smi)} cards: {smi}")
    print(f"[stages] stages: {where}")
    print(f"[stages] {m} microbatches: {ms:.2f} ms a microbatch (host clock,"
          f" after one of warm-up); a hop {2 * toks[0].size * cfg.d_model} "
          f"bytes (bf16 bits, in a 4 MiB ring slot), the logits "
          f"{outs[0][0].nbytes} bytes (the store's oversize path); launches "
          f"per stage {launches}; DAG {stats}; logits differ from the whole "
          f"run's at microbatches {differ or 'none'}")
    assert len({w["pid"] for w in where} | {os.getpid()}) == n + 1
    assert len({w["uuid"] for w in where}) == n
    assert [w["device"] for w in where] == [f"cuda:{i}" for i in range(n)]
    assert not differ
    per = cfg.n_layers // n * (m + 1)
    assert launches == [{"flash_fwd": per, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0}] * n


@pytest.mark.cuda
@pytest.mark.timeout(900)
def test_collective_groups_of_actors_across_cards(monkeypatch):
    """util.collective's groups between four ray_tpu actors, one card each
    (actor i binds cuda:i before its NCCL group is made), joined by
    create_collective_group(..., backend="nccl", runtime=ray_tpu): JAX's
    three cases (tests/test_collective.py :11, :58, :82) on seeded card
    tensors, plus a ring exchange and a second NCCL group of two of the
    actors (ranks reversed) whose ops interleave with the first's, each
    result against numpy (float64 sums within 1e-12 relative, the rest
    exactly) and back on the card. Then GPT-2 small's bf16 parameters
    broadcast from rank 0 to the other three, equal bit for bit to each
    receiver's own init from the same seed: ms (median of 5 after one
    warm-up, the slowest rank each time, host clock after a device sync)
    and GB/s over NCCL, beside the same tree through a gloo group of the
    same actors (median of 3). Prints the cards' name and power limit,
    each create_collective_group's wall time, the card memory each NCCL
    group adds per rank, and the allocator peak of one broadcast per rank.
    Needs four cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import os
    import statistics
    import subprocess
    import time

    import ray_tpu

    from ray_tpu_torch.util.collective import (CollectiveGroupMixin,
                                               create_collective_group)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    n = 4
    rng = np.random.default_rng(0)
    inp = dict(x=[rng.standard_normal(4) for _ in range(n)],
               b=rng.standard_normal(3),
               ints=[rng.integers(-99, 99, 3) for _ in range(n)],
               rs=[rng.standard_normal((6, 2)) for _ in range(n)],
               half=[rng.standard_normal(5) for _ in range(n)],
               msg=rng.standard_normal(2),
               sym=[rng.standard_normal(3) for _ in range(n)],
               tw=[rng.standard_normal((2, 2)) for _ in range(n)],
               tb=[rng.standard_normal(2) for _ in range(n)])
    half_rank = {3: 0, 2: 1}

    class Member(CollectiveGroupMixin):
        """One card's member; ray_tpu ships this class by value, so its
        methods import the port in their bodies."""

        def __init__(self, card):
            import torch
            torch.cuda.set_device(card)
            self.dev = torch.device("cuda", card)
            self.tree = None

        def where(self):
            import os

            import torch
            return {"pid": os.getpid(), "device": str(self.dev),
                    "uuid": str(torch.cuda.get_device_properties(
                        self.dev).uuid)}

        def card_used(self):
            """Bytes in use on this actor's card, NCCL's own included."""
            import torch
            free, total = torch.cuda.mem_get_info(self.dev)
            return total - free

        def cases(self, rank, inp, half_rank):
            import time

            import torch

            from ray_tpu_torch.util import collective as col
            n = col.get_collective_group_size("all")

            def card(a):
                return torch.tensor(a, device=self.dev)
            g = dict(group_name="all")
            out = {"allreduce": col.allreduce(card(inp["x"][rank]), **g),
                   "max": col.allreduce(card(inp["x"][rank]),
                                        op=col.ReduceOp.MAX, **g),
                   "bcast": col.broadcast(card(inp["b"]) if rank == 1
                                          else None, src_rank=1, **g),
                   "allgather": col.allgather(
                       card(inp["ints"][rank][:rank + 1]), **g),
                   "rs": col.reducescatter(card(inp["rs"][rank]), **g),
                   "reduce": col.reduce(card(inp["x"][rank]), dst_rank=3,
                                        **g)}
            if rank in half_rank:
                out["half"] = col.allreduce(card(inp["half"][rank]),
                                            group_name="half")
            col.barrier(**g)
            # Point to point makes its links at first use: the wall time
            # and card bytes of each group's first exchanges, and the
            # links each rank made (none before).
            p2p = {"links_before": {k: col.pair_links(k) for k in (
                ["all", "half"] if rank in half_rank else ["all"])}}
            torch.cuda.synchronize(self.dev)
            p2p["used"], t0 = [self.card_used()], time.perf_counter()
            if rank == 0:
                col.send(card(inp["msg"]), dst_rank=1, **g)
            elif rank == 1:
                out["recv"] = col.recv(src_rank=0, **g)
            col.send(card(inp["sym"][rank]), dst_rank=rank ^ 1, **g)
            out["sym"] = col.recv(src_rank=rank ^ 1, **g)
            col.send(card(inp["sym"][rank]), dst_rank=(rank + 1) % n, **g)
            out["ring"] = col.recv(src_rank=(rank - 1) % n, **g)
            p2p["links"] = {"all": col.pair_links("all")}
            torch.cuda.synchronize(self.dev)
            p2p["ms"] = {"all": 1e3 * (time.perf_counter() - t0)}
            p2p["used"].append(self.card_used())
            if rank in half_rank:
                peer = 1 - half_rank[rank]
                t0 = time.perf_counter()
                col.send(card(inp["half"][rank]), dst_rank=peer,
                         group_name="half")
                out["half_recv"] = col.recv(src_rank=peer, group_name="half")
                p2p["links"]["half"] = col.pair_links("half")
                torch.cuda.synchronize(self.dev)
                p2p["ms"]["half"] = 1e3 * (time.perf_counter() - t0)
                p2p["used"].append(self.card_used())
            out["tree"] = col.allreduce({"w": card(inp["tw"][rank]),
                                         "b": card(inp["tb"][rank])}, **g)
            leaves = [v for v in out.values() for v in (
                v.values() if isinstance(v, dict) else
                v if isinstance(v, list) else [v])]
            on_card = all(isinstance(v, torch.Tensor) and v.device == self.dev
                          for v in leaves)

            def host(v):
                if isinstance(v, dict):
                    return {k: host(w) for k, w in v.items()}
                if isinstance(v, list):
                    return [host(w) for w in v]
                return v.cpu().numpy()
            return {k: host(v) for k, v in out.items()}, on_card, p2p

        def tree_broadcast(self, rank, group, reps):
            import time

            import torch

            from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
            from ray_tpu_torch.util import collective as col
            if self.tree is None:
                model = gpt_init(GPTConfig.gpt2_small(), device=self.dev)
                self.tree = {k: p.detach().to(torch.bfloat16)
                             for k, p in model.named_parameters()}
            times = []
            torch.cuda.reset_peak_memory_stats(self.dev)
            base = torch.cuda.memory_allocated(self.dev)
            for i in range(reps + 1):
                col.barrier(group_name=group)
                t0 = time.perf_counter()
                got = col.broadcast(self.tree if rank == 0 else None,
                                    src_rank=0, group_name=group)
                torch.cuda.synchronize(self.dev)
                times.append(1e3 * (time.perf_counter() - t0))
                if i == 0:   # the first broadcast's peak, its result in it
                    peak = torch.cuda.max_memory_allocated(self.dev) - base
            same = list(got) == list(self.tree) and all(
                torch.equal(got[k].to(self.dev), v)
                for k, v in self.tree.items())
            return {"ms": times[1:], "same": same, "peak": peak,
                    "bytes": sum(v.numel() * v.element_size()
                                 for v in self.tree.values()),
                    "params": sum(v.numel() for v in self.tree.values()),
                    "leaves": len(self.tree)}

    ray_tpu.init(num_cpus=8, num_tpus=n)
    try:
        cls = ray_tpu.remote(num_cpus=1, num_gpus=1)(Member)
        actors = [cls.remote(i) for i in range(n)]
        where = ray_tpu.get([a.where.remote() for a in actors], timeout=300)

        def used():
            return ray_tpu.get([a.card_used.remote() for a in actors],
                               timeout=60)
        setup, card = {}, [used()]
        for name, members, backend in (
                ("all", actors, "nccl"), ("half", [actors[3], actors[2]],
                                          "nccl")):
            t0 = time.perf_counter()
            create_collective_group(members, len(members),
                                    list(range(len(members))),
                                    backend=backend, group_name=name,
                                    runtime=ray_tpu)
            setup[name] = 1e3 * (time.perf_counter() - t0)
            card.append(used())
        cases = ray_tpu.get([a.cases.remote(r, inp, half_rank)
                             for r, a in enumerate(actors)], timeout=300)
        nccl = ray_tpu.get([a.tree_broadcast.remote(r, "all", 5)
                            for r, a in enumerate(actors)], timeout=300)
        t0 = time.perf_counter()
        create_collective_group(actors, n, list(range(n)), backend="gloo",
                                group_name="host", runtime=ray_tpu)
        setup["host"] = 1e3 * (time.perf_counter() - t0)
        gloo = ray_tpu.get([a.tree_broadcast.remote(r, "host", 3)
                            for r, a in enumerate(actors)], timeout=600)
        for a in actors:
            ray_tpu.kill(a)
    finally:
        ray_tpu.shutdown()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()

    def summary(runs):
        ms = statistics.median(max(r["ms"][i] for r in runs)
                               for i in range(len(runs[0]["ms"])))
        return ms, runs[0]["bytes"] / ms / 1e6
    (nccl_ms, nccl_gbs), (gloo_ms, gloo_gbs) = summary(nccl), summary(gloo)
    tree = nccl[0]
    print(f"\n[collective] {len(smi)} cards: {smi}")
    print(f"[collective] actors: {where}")
    print(f"[collective] create_collective_group wall ms: NCCL world 4 "
          f"{setup['all']:.1f}, NCCL world 2 {setup['half']:.1f}, gloo "
          f"world 4 {setup['host']:.1f}; card bytes in use per rank (NCCL's "
          f"own included) added by the world-4 group "
          f"{[b - a for a, b in zip(card[0], card[1])]}, by the world-2 "
          f"group {[b - a for a, b in zip(card[1], card[2])]}; allocator "
          f"peak of one NCCL broadcast per rank (result included) "
          f"{[r['peak'] for r in nccl]}")
    p2p = [extra for _, _, extra in cases]
    print(f"[collective] first point-to-point exchanges, links made at first "
          f"use: wall ms per rank, group 'all' (0->1, partners, ring) "
          f"{[round(x['ms']['all'], 1) for x in p2p]}, group 'half' "
          f"{[round(x['ms'].get('half', 0.0), 1) for x in p2p]}; card bytes "
          f"they added per rank, 'all' "
          f"{[x['used'][1] - x['used'][0] for x in p2p]}, 'half' "
          f"{[x['used'][-1] - x['used'][1] for x in p2p]}; links made "
          f"{[x['links'] for x in p2p]}")
    print(f"[collective] GPT-2 small's parameter tree ({tree['leaves']} "
          f"leaves, {tree['params']} parameters, {tree['bytes']} bytes bf16)"
          f" broadcast from rank 0 to 3 ranks ({3 * tree['bytes']} bytes "
          f"delivered): NCCL {nccl_ms:.3f} ms, {nccl_gbs:.1f} GB/s "
          f"(bytes / time); gloo {gloo_ms:.1f} ms, {gloo_gbs:.2f} GB/s "
          f"(per rank: NCCL {[r['ms'] for r in nccl]}, gloo "
          f"{[r['ms'] for r in gloo]})")
    assert len({w["pid"] for w in where} | {os.getpid()}) == n + 1
    assert len({w["uuid"] for w in where}) == n
    assert [w["device"] for w in where] == [f"cuda:{i}" for i in range(n)]
    assert all(on_card for _, on_card, _ in cases)
    outs = [out for out, _, _ in cases]
    # Links only where a rank sent or received: none before; after, both
    # directions with its partner (rank ^ 1) and, from the ring, the link
    # from its predecessor and to its successor.
    for r, x in enumerate(p2p):
        assert all(v == [] for v in x["links_before"].values()), x
        want = sorted({(r, r ^ 1), (r ^ 1, r), ((r - 1) % n, r),
                       (r, (r + 1) % n)})
        assert [tuple(k) for k in x["links"]["all"]] == want, (r, x)
        if r in half_rank:
            assert [tuple(k) for k in x["links"]["half"]] == [(0, 1), (1, 0)]
    total = sum(inp["x"])
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["allreduce"], total, rtol=1e-12)
        np.testing.assert_array_equal(out["max"], np.maximum.reduce(inp["x"]))
        np.testing.assert_array_equal(out["bcast"], inp["b"])
        np.testing.assert_array_equal(
            np.concatenate(out["allgather"]),
            np.concatenate([inp["ints"][i][:i + 1] for i in range(n)]))
        np.testing.assert_allclose(
            out["rs"], np.array_split(sum(inp["rs"]), n)[r], rtol=1e-12)
        if r == 3:
            np.testing.assert_allclose(out["reduce"], total, rtol=1e-12)
        else:
            np.testing.assert_array_equal(out["reduce"], inp["x"][r])
        np.testing.assert_array_equal(out["sym"], inp["sym"][r ^ 1])
        np.testing.assert_array_equal(out["ring"], inp["sym"][(r - 1) % n])
        np.testing.assert_allclose(out["tree"]["w"], sum(inp["tw"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(out["tree"]["b"], sum(inp["tb"]),
                                   rtol=1e-12)
        if r in half_rank:
            np.testing.assert_array_equal(out["half"],
                                          inp["half"][2] + inp["half"][3])
            np.testing.assert_array_equal(out["half_recv"],
                                          inp["half"][5 - r])
    np.testing.assert_array_equal(outs[1]["recv"], inp["msg"])
    assert all(r["same"] for r in nccl + gloo)
