"""Found by name from BENCHMARK.json and the traffic files."""
