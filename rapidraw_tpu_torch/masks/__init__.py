"""Mask rasterization: adjustment-JSON mask definitions -> (N, H, W) bitmaps."""
