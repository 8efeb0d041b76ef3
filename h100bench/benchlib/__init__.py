"""The benchmark's shared yardstick: weights from the seed, the environment,
statistics, the roofline arithmetic and the trace reductions. The program
under test is reached only through ``program.py``."""
