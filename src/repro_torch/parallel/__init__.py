"""Sharding plan and parameter layout."""
