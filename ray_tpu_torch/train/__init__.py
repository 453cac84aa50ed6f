"""Training of the port (``ray_tpu/train``): the train step, on one device
or over a mesh with any strategy, sharded checkpoints of its state, and the
Train harness that runs a train loop on a gang of workers, one card each
(``Trainer``, JAX's ``JaxTrainer``), with the per-worker session API
(``report``, ``get_checkpoint``, ``get_context``).

Of ``ray_tpu.train``'s ``__all__`` these are not ported: the sklearn, GBDT
(XGBoost, LightGBM), TensorFlow, Hugging Face and torch DDP trainers and
their helpers (``TensorflowConfig``, ``build_tf_config``, ``TorchConfig``,
``prepare_model``, ``prepare_data_loader``, ``prepare_trainer``), which
run no JAX compute; ``JaxBackendConfig`` is ``CudaBackendConfig`` here.
"""

from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                            new_checkpoint_dir, save_pytree)
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.session import (TrainContext, get_checkpoint,
                                         get_context, get_dataset_shard,
                                         report, should_checkpoint)
from ray_tpu_torch.train.train_step import (AdamW, TrainState, adamw,
                                            init_train_state,
                                            make_eval_step, make_train_step)
from ray_tpu_torch.train.backend_executor import (BackendConfig,
                                                  BackendExecutor,
                                                  CudaBackendConfig,
                                                  TrainingFailedError)
from ray_tpu_torch.train.trainer import Result, Trainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "AdamW", "BackendConfig", "BackendExecutor", "Checkpoint",
    "CheckpointConfig", "CudaBackendConfig", "FailureConfig", "Result",
    "RunConfig", "ScalingConfig", "TrainContext", "TrainState", "Trainer",
    "TrainingFailedError", "WorkerGroup", "adamw", "get_checkpoint",
    "get_context", "get_dataset_shard", "init_train_state", "load_pytree",
    "make_eval_step", "make_train_step", "new_checkpoint_dir", "report",
    "save_pytree", "should_checkpoint",
]
