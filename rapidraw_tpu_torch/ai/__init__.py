"""The AI networks of the port: U2-Net (foreground and sky), Depth-Anything
v2 ViT-S, SAM ViT-B, the NIND UtNet denoiser and LaMa, as torch modules
of plain PyTorch ops (ai/layers.py), with their entries:

  * masks.precompute_ai_submasks — fills an editor's AI sub-masks
    (ai-foreground, quick-eraser, ai-sky, ai-depth, ai-subject);
  * denoise.denoise_ai — `python -m rapidraw_tpu_torch denoise --method ai`;
  * inpaint.generate_replace_patch — generative replace (aiPatches);
  * connector — the HTTP inpainting middleware client.

Port of `rapidraw_tpu/ai/` without its tagging modules (CLIP: slice
A.13b). Each network reads the JAX package's flat npz from the same
directory and runs on the caller's device (CUDA unless asked), in float32
with TF32 off.
"""
