"""Tests of the benchmark (CPU; those marked ``cuda`` need a card)."""
