"""The port's benchmark harness: general code that every cell shares.

A cell is found by name in ``BENCHMARK.json``; its configuration, traffic
mix, limits and metric readers are files under ``bench/`` named after
them, so a new cell, mix, configuration or metric is new files and a new
``BENCHMARK.json`` entry, and no edit here. Nothing in this package
imports ``jax``, ``jaxlib`` or ``repro``; the plain reference under
``bench/reference/`` imports nothing of ``repro_torch`` either.
"""
