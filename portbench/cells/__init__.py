"""The runners of a cell's run, one per traffic generator."""
