"""One module a training loop. Each builds a cell from its configuration
and workload files and gives the harness a :class:`Cell`-like object:
``leaves``, ``opt``, ``step()``, ``reference_inputs()``, ``close()`` and
the counts its metrics read (see ``benchmark/README.md``)."""
