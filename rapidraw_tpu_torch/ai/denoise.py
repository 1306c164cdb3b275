"""AI denoiser: UtNet (NIND) and its tiled execution.

Port of `rapidraw_tpu/ai/denoise.py` (ai_processing.rs denoise path +
denoising.rs:51-88 'ai' mode). Weights load from utnet.npz in the models
directory (ai/masks.py); `denoise_ai` raises ModelUnavailable otherwise.

UtNet (Benoit Brummer, "Natural Image Noise Dataset", CVPRW 2019) is a
U-Net: 4 down levels (conv-conv-pool) widening 32..256, a bottleneck, and
transpose-conv up path with skip concatenation, LeakyReLU 0.1 activations.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from rapidraw_tpu_torch.ai.layers import Conv, ConvTranspose, Named, exact_fp32, fp32_forward
from rapidraw_tpu_torch.ai.masks import _load_variables, as_image, utnet_weights
from rapidraw_tpu_torch.ai.tiled_inference import run_tiled, select_tile_params


@dataclasses.dataclass(frozen=True)
class UtNetConfig:
    base: int = 32


UTNET = UtNetConfig()  # what denoise_ai runs


class UtNet(Named):
    """(B, 3, H, W) -> (B, 3, H, W); H and W multiples of 16."""

    def __init__(self, config: UtNetConfig = UTNET):
        super().__init__()
        f, cin = config.base, 3
        self.down = []
        for _ in range(4):
            self.down.append((self.auto("Conv", Conv(cin, f, 3)), self.auto("Conv", Conv(f, f, 3))))
            cin, f = f, f * 2
        self.bottom = (self.auto("Conv", Conv(cin, f, 3)), self.auto("Conv", Conv(f, f, 3)))
        self.up = []
        for _ in range(4):
            half = f // 2
            self.up.append((self.auto("ConvTranspose", ConvTranspose(f, half, 2, 2)),
                            self.auto("Conv", Conv(2 * half, half, 3)),
                            self.auto("Conv", Conv(half, half, 3))))
            f = half
        self.last = [self.auto("Conv", Conv(f, 3, 3))]

    @fp32_forward
    def forward(self, x):
        def act(v):
            return F.leaky_relu(v, 0.1)

        skips = []
        for c1, c2 in self.down:
            x = act(c2(act(c1(x))))
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)  # flax max_pool VALID: floor
        x = act(self.bottom[1](act(self.bottom[0](x))))
        for (t, c1, c2), skip in zip(self.up, reversed(skips)):
            x = t(x)
            x = torch.cat([x[:, :, : skip.shape[2], : skip.shape[3]], skip], 1)
            x = act(c2(act(c1(x))))
        return self.last[0](x)


def denoise_ai(image, quality: float = 0.5, device="cuda") -> torch.Tensor:
    """Denoise planar (3, H, W) float32 with UtNet over blended tiles on
    `device`; returns the (3, H, W) result there.

    Raises ModelUnavailable when weights are absent (the caller falls back
    to BM3D, like the reference without its model download).
    """
    dev = torch.device(device)
    config = UTNET
    model = _load_variables("utnet.npz", "NIND UtNet", lambda f: utnet_weights(f, config),
                            dev, config)
    params = select_tile_params(quality)

    def fwd(batch):  # (B, 3, cs, cs) planar -> same
        # the U-Net's 4 pool/upsample levels need 16-divisible sides; the
        # tile context size (504, mirroring the reference's tiling) is not
        # one: reflect-pad in, crop out
        h, w = batch.shape[2], batch.shape[3]
        x = F.pad(batch, (0, -w % 16, 0, -h % 16), mode="reflect")
        return model(x)[:, :, :h, :w]

    with exact_fp32():
        return run_tiled(fwd, as_image(image, dev), params)
