"""Analytics: histogram, waveform/parade/vectorscope, auto-adjust.

Host-side NumPy ports of image_processing.rs:2553-3262, copied from the JAX
package's `rapidraw_tpu/analysis`: the reference runs these on a dedicated
analytics thread off the rendered image (lib.rs:616-648); here they are a
post-develop service step on the host copy of the output
(pipeline/service.py).
"""
