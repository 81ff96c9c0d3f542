"""What the harness shares across cells: the spec, the clock, the trace."""
