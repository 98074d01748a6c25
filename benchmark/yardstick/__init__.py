"""The yardstick: peaks, bounds, FLOP counts, trace reading and run
statistics, kept with the benchmark so that the program cannot move
them."""
