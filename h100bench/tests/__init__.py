"""CPU tests of the benchmark harness (and `cuda` tests that need a card)."""
