"""The harness of the benchmark of ``picasso_torch``: the spec in
``BENCHMARK.json``, the run of one cell, the device, the trace."""
