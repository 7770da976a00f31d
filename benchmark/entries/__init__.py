"""One module per program entry that a traffic mix can drive, named as the
mix's ``entry`` names it. Each holds an ``Entry`` class: set-up and warm-up,
the inputs of a call, the call itself, its record, the program's counters,
and the check of its answers against ``benchmark.reference``."""
