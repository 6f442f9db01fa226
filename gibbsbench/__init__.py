"""The benchmark of pyglm_tpu_torch on one NVIDIA H100.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 -m gibbsbench.run --workload flagship.high --seed 7 \
        --seconds 30 --trace 0

Everything that belongs to one configuration, traffic mix, metric, kernel
or cell lives in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``work/<kernel>.py`` and ``limits/<workload>.json``.
The plain reference that decides ``correct`` is ``reference/``; it imports
nothing of the program.
"""
