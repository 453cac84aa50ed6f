"""The architectures the benchmark knows, one package each, named by a
configuration's ``"architecture"`` (``gpt`` where it names none): its
``spec.py``, ``reference.py`` and ``program.py``, under the contract that
``benchmark/README.md`` sets out ("Adding to it")."""
