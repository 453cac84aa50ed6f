"""The port of ``ray_tpu/rllib``'s compute: networks, the model catalog,
learners and env runners, in torch.

Each module mirrors its JAX counterpart (``ray_tpu_torch/rllib/catalog.py``
against ``ray_tpu/rllib/catalog.py``) and is held against it by
``tests/test_torch_rllib_*.py``. The orchestration (``Algorithm``, a
``tune.Trainable`` whose runners are actors, and each algorithm's
``training_step``) holds no JAX and is not ported: the learners and runners
here are plain classes that a caller composes as ``training_step`` does.
The pure-numpy modules the compute needs (``sample_batch``, ``env``,
``connectors``, ``replay_buffer``, ``offline``) are the port's own copies.
"""
