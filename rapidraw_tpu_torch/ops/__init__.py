"""Per-pixel image ops as plain PyTorch functions over PLANAR (3, H, W)
float32 tensors, one module per module of `rapidraw_tpu.ops`.

Scalar adjustment params arrive as 0-d tensors (or Python floats) and
broadcast against the pixels. Each function keeps the JAX op order, so the
CPU comparison against the JAX package is like for like; the CUDA grade
kernel (csrc/grade.cu) transcribes the same arithmetic per pixel.
"""
