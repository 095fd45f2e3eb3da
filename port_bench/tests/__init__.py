"""CPU tests of the benchmark's harness (``pytest port_bench/tests``); the
tests marked ``cuda`` run on the card and skip elsewhere."""
