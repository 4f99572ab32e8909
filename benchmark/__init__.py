"""The benchmark of ``krr_tpu_torch``: whole one-shot scans through
``Runner.run`` on generated fleets, one cell per entry of ``BENCHMARK.json``.
``python3 benchmark/run.py --help`` says how to run a cell."""
