"""The port's ``rllib`` command: ``ray_tpu/scripts/cli.py``'s ``cmd_rllib``
(:282) and its parser (:496-518), run as ``python -m ray_tpu_torch rllib
train|evaluate ...``.

The arguments, their defaults, the lines printed and the usage errors are
JAX's. The algorithm is the port's ``*Config`` of that name from
``ray_tpu_torch.rllib``. A command line cannot be handed a runtime, so the
runners run in this process (``util.local_runtime``), on the card unless
``--device`` names another device; ``--num-cpus`` is accepted and means
nothing here. The checkpoint is the algorithm's ``save_checkpoint()``
state, its tensors on the host, with ``cli_config`` and ``cli_env`` as
JAX writes them, pickled; evaluate loads it onto ``--device``. The other
commands of JAX's CLI drive the cluster runtime and are not the port's.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys

# Modules a checkpoint of this CLI never references: a checkpoint that
# names them was written by another package (JAX's holds jax arrays).
_FOREIGN = ("jax", "jaxlib", "optax", "ray_tpu", "cloudpickle")


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            raise pickle.UnpicklingError(
                f"it references {module}.{name}")
        return super().find_class(module, name)


def _load_checkpoint(path: str) -> dict:
    """The state ``train`` wrote, or exit with a usage error."""
    import torch
    with open(path, "rb") as f:
        try:
            ckpt = _CheckpointUnpickler(f).load()
        except (pickle.UnpicklingError, EOFError, AttributeError,
                ImportError) as e:
            sys.exit(f"error: {path} is not a checkpoint of "
                     f"`python -m ray_tpu_torch rllib train` ({e})")
    params = ckpt.get("params") if isinstance(ckpt, dict) else None
    if not isinstance(params, dict) or not all(
            torch.is_tensor(v) for v in params.values()):
        sys.exit(f"error: {path} is not a checkpoint of "
                 "`python -m ray_tpu_torch rllib train` (its params are "
                 "not a state dict of torch tensors)")
    return ckpt


def cmd_rllib(args):
    """RLlib CLI (reference: rllib/train.py `rllib train` +
    rllib/evaluate.py `rllib evaluate`): run an algorithm on an env from
    the command line; evaluate a saved checkpoint greedily."""
    from ray_tpu_torch import rllib as rl
    from ray_tpu_torch.rllib.algorithm import to_host
    config_cls = getattr(rl, f"{args.algo}Config", None)
    if config_cls is None:
        sys.exit(f"error: unknown algorithm {args.algo!r}; see "
                 f"ray_tpu_torch.rllib.__all__ for available *Config "
                 f"classes")
    config_json = args.config
    if args.rllib_cmd == "evaluate":
        # Usage errors before paying for the build.
        if not args.checkpoint_path:
            sys.exit("error: evaluate needs --checkpoint-path")
        ckpt = _load_checkpoint(args.checkpoint_path)
        # Train-time config rides in the checkpoint so evaluate builds
        # the SAME network without the user repeating --config.
        if not config_json:
            config_json = ckpt.get("cli_config", "")
        saved_env = ckpt.get("cli_env")
        if saved_env and saved_env != args.env:
            sys.exit(f"error: checkpoint was trained on env "
                     f"{saved_env!r}; pass --env {saved_env}")
    cfg = config_cls().environment(args.env).resources(device=args.device)
    if config_json:
        try:
            overrides = json.loads(config_json)
            if not isinstance(overrides, dict):
                raise ValueError("--config must be a JSON object")
            cfg.training(**overrides)
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            sys.exit(f"error: bad --config: {e}")
    if args.rllib_cmd == "evaluate":
        if cfg.is_multi_agent:
            sys.exit("error: evaluate supports single-policy "
                     "checkpoints only")
        from ray_tpu_torch.rllib.env import make_env
        if make_env(args.env, cfg.env_config).continuous:
            sys.exit("error: evaluate supports discrete-action "
                     "policy/Q algorithms only")
        cfg.env_runners(num_env_runners=1)  # one greedy evaluator
    algo = cfg.build()
    try:
        if args.rllib_cmd == "train":
            best = float("-inf")
            for i in range(args.stop_iters):
                r = algo.step()
                rew = r.get("episode_reward_mean", float("nan"))
                if rew == rew:
                    best = max(best, rew)
                print(f"iter {i + 1}: reward_mean="
                      f"{rew if rew == rew else 'n/a'} "
                      f"episodes={r.get('episodes_total', 0)}", flush=True)
                if args.stop_reward is not None and rew == rew \
                        and rew >= args.stop_reward:
                    print(f"stop-reward {args.stop_reward} reached")
                    break
            if best > float("-inf"):
                print(f"best reward_mean: {best:.2f}")
            if args.checkpoint_path:
                state = to_host(algo.save_checkpoint())
                state["cli_config"] = args.config
                state["cli_env"] = args.env
                with open(args.checkpoint_path, "wb") as f:
                    pickle.dump(state, f)
                print(f"checkpoint written to {args.checkpoint_path}")
        else:  # evaluate
            if not hasattr(algo, "learner"):
                sys.exit(f"error: {args.algo} has no single-learner "
                         f"checkpoint to evaluate")
            ckpt.pop("cli_config", None)
            ckpt.pop("cli_env", None)
            algo.load_checkpoint(ckpt)
            weights = algo.learner.get_weights()
            ret = algo._rt.get(
                algo.env_runners[0].evaluate_return.remote(
                    weights, episodes=args.episodes), timeout=600)
            print(f"mean_return={ret:.2f} over {args.episodes} episodes")
    finally:
        algo.cleanup()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch command line")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("rllib", help="rllib train/evaluate")
    rsub = s.add_subparsers(dest="rllib_cmd", required=True)
    for name in ("train", "evaluate"):
        r = rsub.add_parser(name)
        r.add_argument("--algo", default="PPO",
                       help="algorithm name (PPO, A2C, PG, DQN, C51, "
                            "QRDQN, ...; evaluate needs a "
                            "discrete-action single-learner algo)")
        r.add_argument("--env", default="CartPole-v1")
        r.add_argument("--config", default="",
                       help="JSON dict of .training(...) overrides")
        r.add_argument("--num-cpus", type=int, default=4,
                       dest="num_cpus",
                       help="accepted for JAX's command line; the runners "
                            "run in this process and it means nothing here")
        r.add_argument("--device", default=None,
                       help="where the learner and runners compute "
                            "(default: the card; 'cpu' for the plain path)")
        r.add_argument("--checkpoint-path", default="",
                       dest="checkpoint_path")
        if name == "train":
            r.add_argument("--stop-iters", type=int, default=10,
                           dest="stop_iters")
            r.add_argument("--stop-reward", type=float, default=None,
                           dest="stop_reward")
        else:
            r.add_argument("--episodes", type=int, default=5)
        r.set_defaults(fn=cmd_rllib)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
