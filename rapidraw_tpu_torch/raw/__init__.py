"""RAW front end of the port: Bayer and X-Trans demosaic, white balance,
the camera matrix, highlight compression and the post-demosaic enhance
pass, as plain PyTorch on the CFA's device (the JAX package's
`rapidraw_tpu.raw`, op for op)."""
