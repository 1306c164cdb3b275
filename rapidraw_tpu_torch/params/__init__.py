"""Host-side parameter layer: adjustment-JSON -> param trees + DevelopConfig.

NumPy only, copied from `rapidraw_tpu.params` so that the port never
imports the JAX package.
"""
