"""Terrain generation of the port (build-time, numpy)."""
