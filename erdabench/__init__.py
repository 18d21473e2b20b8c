"""The port's benchmark: cells of BENCHMARK.json run on one H100
(``python3 -m erdabench.run``).  See ``erdabench/run.py``."""
