"""Per-layer metrics, one reader a file, named as in BENCHMARK.json."""
