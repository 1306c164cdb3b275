"""Compositions: negative conversion, HDR merge, BM3D, culling, panorama."""
