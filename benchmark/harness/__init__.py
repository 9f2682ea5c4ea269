"""The harness: weights and traffic from the seed, the timed loops, the trace reduction and the comparison with the reference."""
