"""Multi-device retrieval and training (port of ``ahrag_tpu/parallel``):
``distributed`` (process groups and a launcher), ``mesh`` (the ``(dp,
corpus)`` mesh and row blocks), ``sharded`` (sharded top-k, a corpus-sharded
graph, tensor-parallel MiniLM) and ``programs`` (the rank functions that the
tests, ``chip_smoke.py`` and ``entry.dryrun_multichip`` start)."""
