"""Benchmark of the PyTorch / CUDA port (``repro_torch``).

One command runs one cell once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, metrics and
bounds.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``   sizes, encoder, engine, check limits;
* ``traffic/<mix>.json``      loop kind, clients, k, query pool, session;
* ``metrics/<metric>.py``     ``read(record)`` of one per-layer metric;
* ``corpora/<generator>.py``  a corpus and query generator on the device;
* ``systems/<system>.py``     how a configuration builds the system under test;
* ``references/<name>.py``    the plain reference that decides ``correct``.

Nothing here imports JAX or the JAX package ``repro``.
"""
