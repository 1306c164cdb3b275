"""Geometry parameters (host side). The warp itself is a later slice."""
