"""Tests of the benchmark harness, run on the CPU."""
