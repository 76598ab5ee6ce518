"""Serving steps and the synthetic token stream."""
