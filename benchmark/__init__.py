"""The benchmark of gcn_maxcut_tpu_torch: cells named in BENCHMARK.json, run
by ``benchmark/run.py``.  It imports no JAX and nothing of the JAX package."""
