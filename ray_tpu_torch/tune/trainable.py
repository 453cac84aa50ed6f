"""Trainables: the port's copy of ``ray_tpu/tune/trainable.py``'s class API
(``Trainable`` :19).

Reference parity: python/ray/tune/trainable/trainable.py (class API). A
subclass implements setup/step/save_checkpoint/load_checkpoint; the config
is held as a dict and ``training_iteration`` starts at 0. The function API
(``tune.report``, ``FunctionRunner``) belongs to Tune's trial actors and
is not copied.

``as_tune_trainable`` runs a port class under a Tune module handed in
(``ray_tpu.tune``): Tune takes a class trainable only if it subclasses its
own ``Trainable`` (``ray_tpu/tune/tuner.py:52``), which the port does not
import.
"""

from __future__ import annotations

import importlib
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


def _port_class(target):
    """The class ``as_tune_trainable`` names: a class of the port imported
    by its module and name in the calling process, or any other class
    itself (it travels by value)."""
    if not isinstance(target, tuple):
        return target
    module, qualname = target
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def as_tune_trainable(cls, tune):
    """``cls``, a port ``Trainable`` subclass (every port ``Algorithm`` is
    one), as a class trainable of the Tune module ``tune``: a subclass of
    ``tune.Trainable``, made at call time, whose ``setup`` builds an
    instance of ``cls`` from the trial's config and whose ``step``,
    ``save_checkpoint``, ``load_checkpoint``, ``reset_config`` and
    ``cleanup`` delegate to it. Tune's class path then runs it, PBT's
    in-place ``reset`` included::

        tune.Tuner(as_tune_trainable(PPO, tune),
                   param_space={"lr": tune.grid_search([1e-4, 5e-4])}).fit()

    Tune ships the subclass to its trial actors by value, so its methods
    import the port there (``cls`` by its module and name): a trial runs
    the port as its process imported it. Checkpoints leave the trial as
    host tensors, so that a card's checkpoint loads anywhere."""
    port = (cls.__module__.split(".")[0] == __name__.split(".")[0]
            and "<locals>" not in cls.__qualname__)
    target = (cls.__module__, cls.__qualname__) if port else cls

    class PortTrainable(tune.Trainable):
        def setup(self, config):
            self._inner = _port_class(target)(config)

        def step(self):
            self._inner.training_iteration = self.training_iteration
            return self._inner.step()

        def save_checkpoint(self):
            from ray_tpu_torch.rllib.algorithm import to_host
            return to_host(self._inner.save_checkpoint())

        def load_checkpoint(self, checkpoint):
            self._inner.load_checkpoint(checkpoint)

        def reset_config(self, new_config):
            if not self._inner.reset_config(new_config):
                return False
            # What Tune does to the instance it holds, after a reset.
            self._inner.config = dict(new_config)
            return True

        def cleanup(self):
            self._inner.cleanup()

    PortTrainable.__name__ = cls.__name__
    return PortTrainable
