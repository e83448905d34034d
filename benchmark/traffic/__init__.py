"""Traffic mixes (data files) and their generators, found by name."""
