"""The port's rllib command line (ray_tpu_torch/scripts/cli.py, run as
``python -m ray_tpu_torch rllib ...``) against JAX's (ray_tpu/scripts/
cli.py ``cmd_rllib``).

tests/test_rllib_cli.py's train -> evaluate flow runs through the port's
parser with ``--device cpu``: JAX's stdout lines, a checkpoint with
``cli_config`` and ``cli_env`` whose state is host tensors. JAX's usage
errors (an unknown algorithm, evaluate without a checkpoint, the wrong
env) exit with JAX's messages: JAX's command raises them before it
starts a cluster, so both run here. A JAX checkpoint exits with a clear
message. No cluster: the command runs in process.
"""

import io
import os
import pickle
import re
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from ray_tpu_torch.scripts.cli import build_parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = '{"train_batch_size": 400, "minibatch_size": 128}'


def _run(argv) -> str:
    args = build_parser().parse_args(argv)
    out = io.StringIO()
    with redirect_stdout(out):
        args.fn(args)
    return out.getvalue()


def _exit_message(parser, argv) -> str:
    args = parser.parse_args(argv)
    with pytest.raises(SystemExit) as info:
        args.fn(args)
    return str(info.value.code)


@pytest.mark.timeout(120)
def test_rllib_cli_train_and_evaluate(tmp_path):
    ckpt = str(tmp_path / "ppo.ckpt")
    out = _run(["rllib", "train", "--algo", "PPO", "--env", "CartPole-v1",
                "--stop-iters", "2", "--checkpoint-path", ckpt,
                "--config", CONFIG, "--device", "cpu"]).splitlines()
    # JAX's lines, word for word.
    assert re.fullmatch(r"iter 1: reward_mean=\d+(\.\d+)? episodes=\d+",
                        out[0]), out
    assert re.fullmatch(r"iter 2: reward_mean=\d+(\.\d+)? episodes=\d+",
                        out[1]), out
    best = max(float(line.split("=")[1].split()[0]) for line in out[:2])
    assert out[2:] == [f"best reward_mean: {best:.2f}",
                       f"checkpoint written to {ckpt}"]
    with open(ckpt, "rb") as f:
        state = pickle.load(f)
    assert state["cli_config"] == CONFIG and state["cli_env"] == "CartPole-v1"
    assert state["iteration"] == 2
    assert state["params"] and all(
        torch.is_tensor(v) and v.device.type == "cpu"
        for v in state["params"].values())

    out = _run(["rllib", "evaluate", "--algo", "PPO", "--env", "CartPole-v1",
                "--checkpoint-path", ckpt, "--device", "cpu",
                "--episodes", "2"])
    assert re.fullmatch(r"mean_return=\d+\.\d\d over 2 episodes\n", out), out


def test_usage_errors_match_jax(tmp_path):
    """JAX's messages, exits before any build; the port names its own
    package's ``__all__`` where JAX names ``ray_tpu.rllib``'s."""
    from ray_tpu.scripts.cli import build_parser as jax_parser
    ckpt = tmp_path / "ppo.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump({"params": {"w": torch.zeros(2)}, "cli_config": "",
                     "cli_env": "CartPole-v1"}, f)
    cases = [
        ["rllib", "train", "--algo", "Nope"],
        ["rllib", "evaluate", "--algo", "PPO"],
        ["rllib", "evaluate", "--algo", "PPO", "--env", "Pendulum-v1",
         "--checkpoint-path", str(ckpt)],
    ]
    for argv in cases:
        port = _exit_message(build_parser(), argv + ["--device", "cpu"])
        jax = _exit_message(jax_parser(), argv)
        assert port == jax.replace("ray_tpu.rllib.", "ray_tpu_torch.rllib."), \
            (port, jax)
    assert port == ("error: checkpoint was trained on env 'CartPole-v1'; "
                    "pass --env CartPole-v1")


def test_evaluate_rejects_a_jax_checkpoint(tmp_path, jax_cpu):
    """A checkpoint of JAX's command (JAX arrays, cloudpickled) exits with
    a usage error and loads no JAX class; a pickle whose params are not a
    state dict likewise."""
    import cloudpickle
    jckpt = tmp_path / "jax.ckpt"
    with open(jckpt, "wb") as f:
        cloudpickle.dump({"params": {"pi": [{"w": jax_cpu.numpy.ones(2)}]},
                          "iteration": 1, "cli_config": "",
                          "cli_env": "CartPole-v1"}, f)
    msg = _exit_message(build_parser(), [
        "rllib", "evaluate", "--checkpoint-path", str(jckpt), "--device",
        "cpu"])
    assert msg.startswith(f"error: {jckpt} is not a checkpoint of "
                          "`python -m ray_tpu_torch rllib train` "
                          "(it references jax"), msg
    nckpt = tmp_path / "numpy.ckpt"
    with open(nckpt, "wb") as f:
        pickle.dump({"params": {"pi": [1.0]}, "cli_env": "CartPole-v1"}, f)
    msg = _exit_message(build_parser(), [
        "rllib", "evaluate", "--checkpoint-path", str(nckpt), "--device",
        "cpu"])
    assert "not a state dict of torch tensors" in msg


@pytest.mark.timeout(60)
def test_python_m_entry_point():
    """``python -m ray_tpu_torch rllib`` runs the command: an unknown
    algorithm exits 1 with JAX's message."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "rllib",
                        "train", "--algo", "Nope"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 1 and p.stdout == ""
    assert p.stderr.strip() == (
        "error: unknown algorithm 'Nope'; see ray_tpu_torch.rllib.__all__ "
        "for available *Config classes")
