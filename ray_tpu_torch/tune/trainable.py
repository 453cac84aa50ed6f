"""Trainables: the port's copy of ``ray_tpu/tune/trainable.py``'s class API
(``Trainable`` :19).

Reference parity: python/ray/tune/trainable/trainable.py (class API). A
subclass implements setup/step/save_checkpoint/load_checkpoint; the config
is held as a dict and ``training_iteration`` starts at 0. The function API
(``tune.report``, ``FunctionRunner``) belongs to Tune's trial actors and
is not copied.
"""

from __future__ import annotations

from typing import Any, Dict


class Trainable:
    """Subclass API: setup/step/save_checkpoint/load_checkpoint."""

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        self.training_iteration = 0
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return None

    def load_checkpoint(self, checkpoint: Any):
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable supports in-place config reset
        (lets PBT reuse the actor instead of restarting it)."""
        return False

    def cleanup(self):
        pass
