"""CPU tests of the benchmark harness; tests marked ``gpu`` need a card."""
