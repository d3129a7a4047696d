"""The benchmark's shared machinery: finding a cell's files, the data,
the run and its result line, device traces, rooflines and card state."""
