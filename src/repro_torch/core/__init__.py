"""Codec, collectives and policies (the port of ``repro.core``)."""
