"""Every phase (setup, call, teardown) of every test collected under the
repo runs under a time limit; see ``_time_limit.py``. The plugin sits here
and not in ``tests/``: ``tests`` has no ``__init__.py``, so a ``tests``
package installed elsewhere on the path would shadow it."""

pytest_plugins = ("_time_limit",)
