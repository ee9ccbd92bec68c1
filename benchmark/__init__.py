"""The port's benchmark: one closed-loop client driving the port's batched
solvers on the card, with cells, configurations, traffic mixes and
per-layer metrics found by name (see ``run.py``)."""
