"""A configuration's architecture: the package ``archs/<arch>/`` beside
``harness`` that the configuration names under ``"architecture"`` (``gpt``
where it names none). The harness takes everything it knows of a model
from there: its spec (``spec.py``), its reference's layer and head
(``reference.py``) and the port's model and loss (``program.py``)."""

from __future__ import annotations

import importlib
from types import ModuleType

DEFAULT = "gpt"


def name(config: dict) -> str:
    return config.get("architecture", DEFAULT)


def spec(config: dict):
    """The spec of ``config``, from its architecture's ``spec.py``."""
    return importlib.import_module(
        f"archs.{name(config)}.spec").from_config(config)


def module(spec, part: str) -> ModuleType:
    """``part`` (``"reference"`` or ``"program"``) of the architecture
    whose ``spec.py`` defines the class of ``spec``."""
    package = type(spec).__module__.rpartition(".")[0]
    return importlib.import_module(f"{package}.{part}")
