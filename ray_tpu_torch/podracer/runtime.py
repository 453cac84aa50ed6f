"""Podracer runtime: the port of ``ray_tpu/podracer/runtime.py``
(``_to_numpy_tree`` :70, ``_RolloutWorker`` :75, ``_Learner`` :139,
``PodracerRun`` :227).

One tick of the substrate (JAX's module docstring):

  caller --(tick, weight_version, weights)--> every rollout actor
      --(fixed-shape trajectory batch)--> learner
      --(version, new weights, metrics)--> caller

The members are the port's ``EnvRunner`` (on the CPU, as JAX's actors
run their policy) and ``PPOLearner`` on the learner's device (None -> the
card). The weights travel as JAX's do, a numpy tree in the JAX layout
(``pi.0.w`` -> ``{"pi": [{"w": ...}]}``), folded from the learner's state
dict once per broadcast: one device-to-host copy per version.

``PodracerRun`` is JAX's run handle. The port imports nothing of
``ray_tpu``, so the runtime is handed in. With ``runtime=ray_tpu`` the
whole path is JAX's: the members are ``ray_tpu`` actors
(``max_restarts=-1``) bound into a ``tick_replay=True`` compiled DAG, the
weight tree rides the control tuple literally below the object plane's
"weights" threshold and as one ``put_object`` per version above it, and a
gang drain migrates the actors with every tick applied exactly once. The
caller imports first what the run reaches through the module:
``ray_tpu.dag.compiled`` (the DAG), ``ray_tpu._private.object_plane``
(the weight broadcast) and ``ray_tpu.util.scheduling_strategies`` (the
plan's node affinity); ``ray_tpu.util.metrics`` and
``ray_tpu.util.tracing`` with ``ray_tpu._private.flightrec`` are optional
and feed the ``ray_tpu_podracer_*`` metrics and the ``podracer:*`` spans.
With no runtime, ``util.local_runtime`` hosts the members in this process
and its DAG runs each tick's collects and learn at submission: a compiled
DAG of depth 1, with no replay.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import device_where
from ray_tpu_torch.models.convert import params_from_jax, unflatten
from ray_tpu_torch.podracer.topology import (PodracerConfig, TopologyPlan,
                                             plan_sliceless)
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import get_env_creator, make_env
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.train.worker_group import (_accelerator, required_attr,
                                              runtime_attr)
from ray_tpu_torch.util import local_runtime
from ray_tpu_torch.util.held import held_result

_PLANE = "ray_tpu._private.object_plane"

# The podracer metrics, made once per metrics module of a runtime.
_metrics: Dict[Any, dict] = {}


def _metric_handles(metrics) -> dict:
    if metrics not in _metrics:
        _metrics[metrics] = {
            "steps": metrics.Counter(
                "ray_tpu_podracer_steps_total",
                "environment steps collected by podracer actor gangs"),
            "batches": metrics.Counter(
                "ray_tpu_podracer_batches_total",
                "trajectory batches delivered act->learn (exactly once "
                "per actor per tick)"),
            "staleness": metrics.Gauge(
                "ray_tpu_podracer_weight_staleness",
                "learner weight version minus the oldest version any "
                "actor sampled with, at the last collected tick"),
        }
    return _metrics[metrics]


def _to_numpy_tree(weights: Dict[str, torch.Tensor]):
    """A state dict -> the JAX-layout tree of numpy arrays, copied (the
    tree outlives the learner's next step, as JAX's immutable arrays do)."""
    return unflatten({k: v.detach().cpu().numpy().copy()
                      for k, v in weights.items()})


class _RolloutWorker:
    """One actor-gang member: wraps an rllib EnvRunner; `collect` is the
    compiled-DAG node method (fixed-shape fragments per tick)."""

    # The columns a PPO learner consumes — everything else the sampler
    # produces stays host-local so the channel message shape is fixed
    # and minimal.
    _COLS = ("obs", "actions", "action_logp", "advantages",
             "value_targets")

    def __init__(self, env_spec, env_config: dict, num_envs: int,
                 fragment_len: int, seed: int, hidden=(32, 32),
                 gamma: float = 0.99, lam: float = 0.95, device=None,
                 resolve=None):
        # resolve: the runtime's object_plane.resolve, which fetches a
        # tree the handle put into the object store (None in process).
        self._resolve = resolve
        self._runner = EnvRunner(env_spec, env_config, num_envs, seed,
                                 hidden=tuple(hidden), device=device)
        self._fragment_len = int(fragment_len)
        self._gamma = float(gamma)
        self._lam = float(lam)
        self._version = 0
        # Bounded: one entry per collect on a loop that ticks forever.
        self._versions_seen: deque = deque(maxlen=4096)

    def collect(self, ctl) -> dict:
        """One rollout fragment under the weights `ctl` announces.
        ctl = (tick, weight_version, weights), weights a JAX-layout numpy
        tree, or a plane ref to one in the object store, fetched only when
        the version advanced."""
        tick, version, weights = ctl
        if weights is not None and version > self._version:
            if self._resolve is not None:
                weights = self._resolve(weights)
            # Copied out of the ring slot / store view once per broadcast
            # (params_from_jax copies each leaf).
            self._runner.set_weights(params_from_jax(weights))
            self._version = version
        self._versions_seen.append(self._version)
        batch = self._runner.sample(self._fragment_len, self._gamma,
                                    self._lam)
        return {
            "tick": tick,
            "version": self._version,
            "ctl_version": version,
            "steps": self._fragment_len * len(self._runner._envs),
            "rewards": self._runner.episode_rewards(),
            "columns": {k: np.asarray(batch[k]) for k in self._COLS},
        }

    def versions_seen(self) -> List[int]:
        """Recent weight versions at each collect, in order (must be
        monotonic — non-decreasing)."""
        return list(self._versions_seen)

    def where(self) -> dict:
        return device_where(self._runner.device)

    def ping(self):
        return True


class _Learner:
    """The learner gang's single rep: consumes every gang's batch each
    tick, runs the PPO update, and stamps a new weight version on a
    cadence, with the weights folded to numpy once per broadcast."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float,
                 hidden=(32, 32), minibatch_size: int = 64,
                 num_epochs: int = 1, broadcast_interval: int = 1,
                 seed: int = 0, device=None):
        self._learner = PPOLearner(obs_dim, num_actions, lr=lr,
                                   hidden=tuple(hidden), seed=seed,
                                   device=device)
        self._minibatch_size = int(minibatch_size)
        self._num_epochs = int(num_epochs)
        self._broadcast_interval = max(1, int(broadcast_interval))
        self._seed = seed
        self._version = 0
        self._weights = None
        self._applied = 0
        self._broadcast()

    def _broadcast(self):
        """Stamp a new version; the numpy param tree rides the output to
        the host loop, which folds it into the next control tuple."""
        self._version += 1
        self._weights = _to_numpy_tree(self._learner.module.state_dict())

    def control(self) -> tuple:
        """(version, weights) for the first control tuple."""
        return (self._version, self._weights)

    def learn(self, *batches) -> dict:
        # Restart resumption: a restarted learner holds fresh params, but
        # the control echo names the live version sequence — resume it so
        # versions observed downstream stay monotonic.
        ctl_version = max(b["ctl_version"] for b in batches)
        if ctl_version > self._version:
            self._version = ctl_version
            self._weights = _to_numpy_tree(self._learner.module.state_dict())
        cols = {k: np.concatenate([b["columns"][k] for b in batches])
                for k in batches[0]["columns"]}
        train = sb.SampleBatch(cols)
        metrics = self._learner.update(
            train, minibatch_size=min(self._minibatch_size,
                                      len(train)) or 1,
            num_epochs=self._num_epochs,
            seed=self._seed + self._applied)
        self._applied += 1
        broadcast = self._applied % self._broadcast_interval == 0
        if broadcast:
            self._broadcast()
        tick = batches[0]["tick"]
        return {
            "tick": tick,
            # Exactly-once probe: applied must equal tick+1 at every
            # collected output.
            "applied": self._applied,
            "tick_skew": sum(1 for b in batches if b["tick"] != tick),
            "version": self._version,
            # Params ride the output only when the version bumped.
            "weights": self._weights if broadcast else None,
            # Per-actor weight versions at sample time, in actor order.
            "versions": [b["version"] for b in batches],
            "staleness": self._version - min(b["version"] for b in batches),
            "num_batches": len(batches),
            "steps": int(sum(b["steps"] for b in batches)),
            "rewards": [r for b in batches for r in b["rewards"]],
            "metrics": {k: float(v) for k, v in metrics.items()},
        }

    def where(self) -> dict:
        return device_where(self._learner.device)

    def ping(self):
        return True


def _probe_env_dims(env_spec, env_config: dict) -> tuple:
    env = make_env(env_spec, env_config)
    return env.observation_dim, env.num_actions


def _leaves(tree):
    """The arrays of a weight tree (dicts and lists of numpy arrays)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class PodracerRun:
    """The run handle: compile once, tick forever (teardown() releases
    the DAG, the gang actors, and the plan's reservations). ``plan``: a
    TopologyPlan, or JAX's (a slice cluster's ``TopologyPlanner(cfg)
    .plan()``); None plans the cluster without slices
    (``plan_sliceless``). ``runtime``: ``ray_tpu`` after ``ray_tpu.init()``
    and the imports the module doc names, or None (this process)."""

    def __init__(self, config: PodracerConfig,
                 plan: Optional[TopologyPlan] = None, runtime=None):
        self.config = config
        # Teardown-relevant state FIRST: any failure mid-__init__ must
        # release whatever was already acquired.
        self._torn_down = False
        self._rt = local_runtime if runtime is None else runtime
        self.plan = None
        self.actors: List[Any] = []
        self.learner = None
        self.members: List[dict] = []
        self.dag = None
        self._pending: deque = deque()
        self.ticks = 0
        self.steps = 0
        # Bounded histories: the handle ticks forever.
        self.episode_rewards: deque = deque(maxlen=1000)
        self.outputs: deque = deque(maxlen=4096)
        self._submit_lock = threading.Lock()
        # Control-tuple form of the current weights: literal tree when
        # small, PlaneRef when oversize (one store put per version). Recent
        # refs stay held so pipelined in-flight ticks can't race the free.
        self._ctl_weights = None
        self._weight_refs: deque = deque(maxlen=8)
        try:
            self._build(config, plan)
        except BaseException:
            self.teardown()
            raise

    @property
    def in_process(self) -> bool:
        return self._rt is local_runtime

    def _build(self, config: PodracerConfig, plan: Optional[TopologyPlan]):
        rt = self._rt
        input_node = required_attr(rt, "dag.InputNode", "ray_tpu.dag")
        compiled = required_attr(rt, "dag.compiled.CompiledDAG",
                                 "ray_tpu.dag.compiled")
        resolve = None if self.in_process else required_attr(
            rt, "_private.object_plane.resolve", _PLANE)
        t0 = time.time()
        self.plan = plan or plan_sliceless(
            config, None if self.in_process else rt)
        creator = get_env_creator(config.env)
        obs_dim, num_actions = _probe_env_dims(creator, config.env_config)

        actor_cls = rt.remote(num_cpus=config.actor_num_cpus)(_RolloutWorker)
        for gang in self.plan.actor_gangs:
            for m in range(config.actors_per_gang):
                opts = dict(gang.member_options[m]
                            if m < len(gang.member_options) else {})
                opts["max_restarts"] = -1
                self.actors.append(actor_cls.options(**opts).remote(
                    creator, config.env_config, config.num_envs,
                    config.fragment_len,
                    seed=config.seed + 1000 * (len(self.actors) + 1),
                    hidden=config.hidden, gamma=config.gamma,
                    lam=config.lam, device="cpu", resolve=resolve))
        learner_cls = rt.remote(num_cpus=config.learner_num_cpus)(_Learner)
        lopts = dict(self.plan.learner.member_options[0]
                     if self.plan.learner.member_options else {})
        lopts["max_restarts"] = -1
        if not self.in_process and torch.device(
                config.device or "cuda").type == "cuda":
            _accelerator(rt)            # raises without an accelerator slot
            lopts["num_gpus"] = 1
        self.learner = learner_cls.options(**lopts).remote(
            obs_dim, num_actions, lr=config.lr, hidden=config.hidden,
            minibatch_size=config.minibatch_size,
            num_epochs=config.num_epochs,
            broadcast_interval=config.broadcast_interval,
            seed=config.seed, device=config.device)

        # Bootstrap: actors start from the learner's version-1 weights
        # (constructor broadcast), so every gang samples the same policy
        # from tick 0.
        ref = self.learner.control.remote()   # held while the copy is made
        self._version, self._weights = self._held(
            lambda: rt.get(ref, timeout=120))
        self._ctl_weights = self._fold_weights(self._weights)
        # Every member answers before the DAG takes them over: its pid,
        # device and card, actors first, the learner last.
        self.members = rt.get([m.where.remote() for m in
                               self.actors + [self.learner]], timeout=120)

        with input_node() as inp:
            root = self.learner.learn.bind(
                *[a.collect.bind(inp) for a in self.actors])
        # patient_readers: every node computes for milliseconds per tick,
        # so blocked channel readers nap rather than hot-poll.
        self.dag = compiled.compile(
            root, channel_depth=config.channel_depth,
            max_message_size=config.max_message_size, tick_replay=True,
            patient_readers=True)
        self._export_span("podracer:compile", t0, time.time())

    def _held(self, resolve):
        """What ``resolve()`` gives (the learner's output and weight tree),
        as the handle keeps it: over a runtime, a copy made while the
        object it came in is still held. A large tree arrives as a view of
        object-store memory that the store reuses once the writer lets
        the object go (ROADMAP R-11), and the handle sends it again in
        later control tuples."""
        if self.in_process:
            return resolve()
        return held_result(self._rt, resolve)

    def _fold_weights(self, weights):
        """Route a weight tree into the control tuple: literal below the
        plane's weights threshold (and always in process), else ONE
        object-plane put for this version with only the ref ringing to
        every actor gang."""
        if weights is None or self.in_process:
            return weights
        plane = required_attr(self._rt, "_private.object_plane", _PLANE)
        size = sum(int(np.asarray(leaf).nbytes) for leaf in _leaves(weights))
        if size < plane.threshold("weights"):
            return weights
        ref = plane.put_object(weights)
        self._weight_refs.append(ref)
        return plane.PlaneRef(ref)

    # -- ticking -------------------------------------------------------
    def submit(self):
        """Submit one tick (pipelined up to channel_depth by the DAG's
        input-write backpressure); pair with collect(). The control tuple
        carries the current weights every tick, so a restarted actor
        re-adopts the live version from its first message."""
        # One lock serializes submitters so the tick in the control tuple
        # cannot desync from the sequence the DAG assigns the write.
        with self._submit_lock:
            ref = self.dag.execute_async(
                (self.dag._next_seq, self._version, self._ctl_weights))
            self._pending.append((ref, time.time()))
        return ref

    def collect(self, timeout: Optional[float] = None) -> dict:
        """Collect the oldest in-flight tick's learner output; folds the
        new weight version into the next control tuple and the podracer
        metrics."""
        ref, t0 = self._pending.popleft()
        out = self._held(lambda: ref.result(timeout))
        if out["version"] > self._version and out["weights"] is not None:
            self._version = out["version"]
            self._weights = out["weights"]
            self._ctl_weights = self._fold_weights(self._weights)
            self._export_span("podracer:broadcast", t0, time.time(),
                              only_if_traced=True)
        self.ticks += 1
        self.steps += out["steps"]
        self.episode_rewards.extend(out["rewards"])
        # Keep the tick record without the param tree.
        self.outputs.append({k: v for k, v in out.items()
                             if k != "weights"})
        metrics = runtime_attr(self._rt, "util.metrics")
        if metrics is not None:
            try:
                m = _metric_handles(metrics)
                m["steps"].inc(out["steps"])
                m["batches"].inc(out["num_batches"])
                m["staleness"].set(float(out["staleness"]))
            except Exception:  # noqa: BLE001 — metrics never block ticks
                pass
        self._export_span("podracer:tick", t0, time.time(),
                          only_if_traced=True)
        return out

    def step(self, timeout: Optional[float] = None) -> dict:
        """One synchronous tick: submit + collect."""
        self.submit()
        return self.collect(timeout)

    def run(self, num_ticks: int, window: Optional[int] = None,
            timeout: Optional[float] = None) -> List[dict]:
        """Windowed pipelined ticking: keep up to `window` ticks in
        flight, collect in submission order."""
        window = max(1, window or self.config.channel_depth)
        out: List[dict] = []
        for _ in range(num_ticks):
            if len(self._pending) >= window:
                out.append(self.collect(timeout))
            self.submit()
        while self._pending:
            out.append(self.collect(timeout))
        return out

    # -- introspection -------------------------------------------------
    def stats(self) -> dict:
        d = self.dag.stats()
        return {
            "mode": self.plan.mode, "ticks": self.ticks,
            "steps": self.steps, "weight_version": self._version,
            "inflight": len(self._pending),
            "max_inflight": d["max_inflight"],
            "recoveries": d["recoveries"],
            "replayed_ticks": d["replayed_ticks"],
            "dag_state": d["state"],
            "staleness": (self.outputs[-1]["staleness"]
                          if self.outputs else 0),
            "episode_reward_mean": (
                float(np.mean(list(self.episode_rewards)[-100:]))
                if self.episode_rewards else float("nan")),
        }

    # -- teardown ------------------------------------------------------
    def teardown(self):
        """Release everything — safe from any partial-__init__ state."""
        if getattr(self, "_torn_down", True):
            return
        self._torn_down = True
        try:
            if self.dag is not None:
                self.dag.teardown()
        finally:
            for a in self.actors + [self.learner]:
                if a is None:
                    continue
                try:
                    self._rt.kill(a)
                except Exception:  # noqa: BLE001 — already gone
                    pass
            if self.plan is not None:
                self.plan.teardown()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass

    def _export_span(self, name: str, start: float, end: float,
                     only_if_traced: bool = False):
        tracing = runtime_attr(self._rt, "util.tracing")
        flightrec = runtime_attr(self._rt, "_private.flightrec")
        if tracing is None or flightrec is None:
            return
        try:
            if only_if_traced and not tracing.is_enabled():
                return
            tracing.export_span(flightrec.span_event(
                name, "podracer", start, end))
        except Exception:  # noqa: BLE001 — observability never blocks
            pass
