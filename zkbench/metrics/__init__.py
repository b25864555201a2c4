"""One reader a metric, named as BENCHMARK.json names the metric (see
cells.py for what a reader declares)."""
