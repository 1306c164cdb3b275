"""The AI networks of the port: U2-Net (foreground and sky), Depth-Anything
v2 ViT-S, SAM ViT-B, the NIND UtNet denoiser, LaMa and CLIP ViT-B/32, as
torch modules of plain PyTorch ops (ai/layers.py), with their entries:

  * masks.precompute_ai_submasks — fills an editor's AI sub-masks
    (ai-foreground, quick-eraser, ai-sky, ai-depth, ai-subject);
  * denoise.denoise_ai — `python -m rapidraw_tpu_torch denoise --method ai`;
  * inpaint.generate_replace_patch — generative replace (aiPatches);
  * connector — the HTTP inpainting middleware client;
  * tagging.index_folder_tags — CLIP ViT-B/32 zero-shot tags into the
    sidecars (`python -m rapidraw_tpu_torch tag`), on clip.py's towers,
    checkpoint.py's reader of a `transformers` save_pretrained directory
    and clip_tokenizer.py's byte-level BPE; tag_data.py holds the labels.

Port of `rapidraw_tpu/ai/`. Each network but CLIP reads the JAX package's
flat npz from the same directory; CLIP reads the save_pretrained directory
JAX's `transformers` reads. All run on the caller's device (CUDA unless
asked), in float32 with TF32 off.
"""
