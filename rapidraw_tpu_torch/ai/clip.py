"""CLIP's two towers and its zero-shot logits, as torch modules.

Computes what `transformers`' `CLIPModel` computes in float32, with the
same parameter names, so a `save_pretrained` state dict carries across by
name (`load_clip_state`):

  * `ClipTextTower` (`text_model.*`): token + position embeddings, pre-norm
    encoder layers under a causal mask plus the padding mask,
    `final_layer_norm`, and the pooled token. With `eos_token_id == 2`
    (the published OpenAI configs) it pools at the first position of each
    row's largest id; otherwise at the first position equal to
    `eos_token_id`, position 0 where the id never occurs (modeling_clip.py
    :627-647). Padding repeats `<|endoftext|>`, so ties are normal: the
    first index is computed here, not taken from `argmax`'s tie rule;
  * `ClipVisionTower` (`vision_model.*`): a bias-free patch convolution, the
    class token, position embeddings, `pre_layrnorm` (sic), the encoder and
    `post_layernorm` on the class token;
  * `ClipModel`: both towers, the bias-free `visual_projection` and
    `text_projection`, and `logits_per_image = exp(logit_scale) *
    normalize(image) @ normalize(text).T`.

Attention is plain float32 softmax(q k^T * scale + mask) v; the MLP's
activation is `hidden_act` (`quick_gelu`, x * sigmoid(1.702 x), or exact
`gelu`). Every forward runs under `ai/layers.exact_fp32` (TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F
from torch import nn

from rapidraw_tpu_torch.ai.layers import Conv, Dense, fp32_forward


@dataclass(frozen=True)
class TextConfig:
    """`CLIPTextConfig`'s fields the tower reads, with its defaults."""
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class VisionConfig:
    """`CLIPVisionConfig`'s fields the tower reads, with its defaults."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class ClipConfig:
    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig()
    projection_dim: int = 512

    @classmethod
    def from_dict(cls, doc: dict) -> ClipConfig:
        """From a checkpoint's `config.json` (keys it leaves out take
        `transformers`' defaults, as it writes only what differs)."""
        def pick(kind, sub):
            names = {f.name for f in fields(kind)}
            return kind(**{k: v for k, v in (sub or {}).items() if k in names})

        return cls(pick(TextConfig, doc.get("text_config")),
                   pick(VisionConfig, doc.get("vision_config")),
                   int(doc.get("projection_dim", 512)))


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"CLIP hidden_act {name!r} is not supported (quick_gelu, gelu)")


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (width // heads) ** -0.5
        self.k_proj = Dense(width, width)
        self.v_proj = Dense(width, width)
        self.q_proj = Dense(width, width)
        self.out_proj = Dense(width, width)

    def forward(self, x, mask=None):
        b, t, d = x.shape

        def split(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        s = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:
            s = s + mask
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class ClipMlp(nn.Module):
    def __init__(self, width: int, inner: int, act: str):
        super().__init__()
        self.act = _activation(act)
        self.fc1 = Dense(width, inner)
        self.fc2 = Dense(inner, width)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class ClipLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.self_attn = ClipAttention(cfg.hidden_size, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = ClipMlp(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(ClipLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids):
        t, n = ids.shape[-1], self.position_embedding.num_embeddings
        if t > n:
            raise ValueError(f"{t} tokens, past the tower's {n} positions")
        return self.token_embedding(ids) + self.position_embedding.weight[:t]


def pool_index(ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """The position each row of `ids` (N, T) is pooled at: the first of its
    largest id when eos_token_id == 2, else the first equal to
    eos_token_id (0 where none is)."""
    t = ids.shape[-1]
    pos = torch.arange(t, device=ids.device).expand_as(ids)
    hit = ids == (ids.max(-1, keepdim=True).values if eos_token_id == 2 else eos_token_id)
    first = torch.where(hit, pos, t).min(-1).values
    return torch.where(first < t, first, 0)


class ClipTextTower(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = ClipEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    @fp32_forward
    def forward(self, ids: torch.Tensor, attention_mask: torch.Tensor | None = None):
        """(last_hidden_state (N, T, D), pooled (N, D)) of token ids (N, T)."""
        n, t = ids.shape
        x = self.embeddings(ids)
        allowed = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()[None, None]
        if attention_mask is not None:
            allowed = allowed & attention_mask.bool()[:, None, None, :]
        mask = torch.zeros(allowed.shape, dtype=x.dtype, device=x.device)
        mask = mask.masked_fill(~allowed, torch.finfo(x.dtype).min)
        last = self.final_layer_norm(self.encoder(x, mask))
        pooled = last[torch.arange(n, device=ids.device), pool_index(ids, self.cfg.eos_token_id)]
        return last, pooled


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size, padding="VALID", bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)

    def forward(self, pixels):
        p = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(p.shape[0], 1, -1)
        return torch.cat([cls, p], dim=1) + self.position_embedding.weight


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = ClipEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    @fp32_forward
    def forward(self, pixels: torch.Tensor):
        """(last_hidden_state (N, 1 + P, D), pooled (N, D)) of normalized
        pixels (N, 3, S, S), S the config's image_size."""
        s = self.cfg.image_size
        if tuple(pixels.shape[-2:]) != (s, s):
            raise ValueError(f"pixels {tuple(pixels.shape)}: the tower takes {s}x{s}")
        last = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return last, self.post_layernorm(last[:, 0])


def _normalize(x):
    return x / torch.pow(torch.sum(torch.pow(x, 2), dim=-1, keepdim=True), 0.5)


class ClipModel(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = ClipTextTower(cfg.text)
        self.vision_model = ClipVisionTower(cfg.vision)
        self.visual_projection = Dense(cfg.vision.hidden_size, cfg.projection_dim, bias=False)
        self.text_projection = Dense(cfg.text.hidden_size, cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    @fp32_forward
    def text_features(self, ids, attention_mask=None):
        return self.text_projection(self.text_model(ids, attention_mask)[1])

    @fp32_forward
    def image_features(self, pixels):
        return self.visual_projection(self.vision_model(pixels)[1])

    @fp32_forward
    def forward(self, pixels, ids, attention_mask=None):
        """logits_per_image (images, texts)."""
        image = _normalize(self.image_features(pixels))
        text = _normalize(self.text_features(ids, attention_mask))
        return (torch.matmul(text, image.t()) * self.logit_scale.exp()).t()


# checkpoints written before position_ids became a non-persistent buffer
_LEGACY_BUFFERS = ("text_model.embeddings.position_ids", "vision_model.embeddings.position_ids")


def load_clip_state(model: ClipModel, state: dict) -> ClipModel:
    """Fill every parameter of `model` from a `transformers` CLIP state dict
    (ai/checkpoint.read_state), consuming each key once; raises ValueError
    on a key left over, a parameter not filled or a shape that differs.
    Only the legacy `position_ids` buffers are passed over."""
    left = {k: v for k, v in state.items() if k not in _LEGACY_BUFFERS}
    missing = []
    for name, p in model.named_parameters():
        t = left.pop(name, None)
        if t is None:
            missing.append(name)
            continue
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"CLIP: {name} has shape {tuple(t.shape)}, the model wants "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(t)
    if missing:
        raise ValueError(f"CLIP: the checkpoint fills no value for {len(missing)} tensors: "
                         f"{missing[:8]}")
    if left:
        raise ValueError(f"CLIP: the checkpoint holds {len(left)} keys the model does not "
                         f"read: {sorted(left)[:8]}")
    return model
