"""Random weights drawn and quantized on the device one tensor at a time (no
public checkpoints in CI or on the card), for the DiT, the VAE and the Qwen3
stacks (text encoder and LM planner)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.quant import QUANT_FORMATS, quantize, supported_format_for
from acestep_tpu_torch.quant.convert import MIN_QUANT_ELEMS


class RandomInit:
    """Draws and quantizes weights on ``device`` one tensor at a time, so a
    full-width engine never holds a bf16 copy of a whole model.  Each kernel's
    format follows the JAX package's ``quantize_tree_jax``: kernels of fewer
    than ``MIN_QUANT_ELEMS`` elements stay bf16, and the rest take
    ``supported_format_for(K, quant)`` (a 4-bit format falls back to q8_0 where
    K % 256 != 0, q8_0 to bf16 where K % 32 != 0)."""

    def __init__(self, device: torch.device, seed: int, quant: Optional[str],
                 dtype=torch.bfloat16):
        if quant is not None and quant not in QUANT_FORMATS:
            raise ValueError(f"quant {quant!r}: the port has None (bf16) and "
                             f"{', '.join(QUANT_FORMATS)}")
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.quant = quant
        self.dtype = dtype

    def normal(self, shape, scale: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device) * scale

    def _format(self, k: int, n: int) -> Optional[str]:
        if self.quant is None or k * n < MIN_QUANT_ELEMS:
            return None
        fmt = supported_format_for(k, self.quant)
        return fmt if fmt in QUANT_FORMATS else None

    def kernel(self, k: int, n: int, layers: Optional[int] = None, scale: float = 0.02):
        """A [K, N] linear kernel; with ``layers``, stacked [L, K, N]."""
        fmt = self._format(k, n)
        if fmt is None:
            shape = (k, n) if layers is None else (layers, k, n)
            return self.normal(shape, scale).to(self.dtype)
        if layers is None:
            return quantize(self.normal((k, n), scale), fmt)
        stacked = None
        for li in range(layers):
            qt = quantize(self.normal((k, n), scale), fmt)
            if stacked is None:
                stacked = qt.map(lambda a: torch.empty((layers,) + tuple(a.shape),
                                                       dtype=a.dtype, device=a.device))
            for f, a in qt.fields().items():
                getattr(stacked, f)[li] = a
        return stacked

    def ones(self, *shape):
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, *shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def dense(self, k: int, n: int, bias: bool = True):
        p = {"kernel": self.kernel(k, n)}
        if bias:
            p["bias"] = self.zeros(n)
        return p

    def attn(self, cfg, layers: Optional[int] = None):
        h, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        lead = () if layers is None else (layers,)
        return {
            "q_proj": {"kernel": self.kernel(h, nh * hd, layers)},
            "k_proj": {"kernel": self.kernel(h, nkv * hd, layers)},
            "v_proj": {"kernel": self.kernel(h, nkv * hd, layers)},
            "o_proj": {"kernel": self.kernel(nh * hd, h, layers)},
            "q_norm": self.ones(*lead, hd),
            "k_norm": self.ones(*lead, hd),
        }

    def mlp(self, h: int, inter: int, layers: Optional[int] = None):
        return {"gate_proj": {"kernel": self.kernel(h, inter, layers)},
                "up_proj": {"kernel": self.kernel(h, inter, layers)},
                "down_proj": {"kernel": self.kernel(inter, h, layers)}}

    def dit(self, cfg: DiTConfig):
        h, nl = cfg.hidden_size, cfg.num_hidden_layers

        def temb():
            return {"linear_1": self.dense(dit.TIME_EMBED_IN, h),
                    "linear_2": self.dense(h, h), "time_proj": self.dense(h, 6 * h)}

        def enc_layer():
            return {"input_norm": self.ones(h), "self_attn": self.attn(cfg),
                    "post_norm": self.ones(h),
                    "mlp": self.mlp(h, cfg.intermediate_size)}

        return {
            "proj_in": self.dense(cfg.in_channels * cfg.patch_size, h),
            "time_embed": temb(),
            "time_embed_r": temb(),
            "condition_embedder": self.dense(h, h),
            "layers": {     # stacked [L, ...] from the start
                "self_attn_norm": self.ones(nl, h),
                "self_attn": self.attn(cfg, nl),
                "cross_attn_norm": self.ones(nl, h),
                "cross_attn": self.attn(cfg, nl),
                "mlp_norm": self.ones(nl, h),
                "mlp": self.mlp(h, cfg.intermediate_size, nl),
                "scale_shift_table": self.zeros(nl, 6, h),
            },
            "norm_out": self.ones(h),
            "out_scale_shift_table": self.zeros(2, h),
            "proj_out": {"kernel": self.kernel(h, cfg.audio_acoustic_hidden_dim * cfg.patch_size),
                         "bias": self.zeros(cfg.audio_acoustic_hidden_dim)},
            "text_projector": self.dense(cfg.text_hidden_dim, h, bias=False),
            "lyric_embed": self.dense(cfg.text_hidden_dim, h),
            "lyric_layers": [enc_layer() for _ in range(cfg.num_lyric_encoder_hidden_layers)],
            "lyric_norm": self.ones(h),
            "timbre_embed": self.dense(cfg.timbre_hidden_dim, h),
            "timbre_layers": [enc_layer() for _ in range(cfg.num_timbre_encoder_hidden_layers)],
            "timbre_norm": self.ones(h),
            "timbre_special_token": self.zeros(h),
        }

    def qwen(self, cfg: QwenConfig):
        h, nl = cfg.hidden_size, cfg.num_hidden_layers
        return {
            "embed_tokens": self.normal((cfg.vocab_size, h), 0.02).to(self.dtype),
            "layers": {
                "input_norm": self.ones(nl, h),
                **self.attn(cfg, nl),
                "post_norm": self.ones(nl, h),
                **self.mlp(h, cfg.intermediate_size, nl),
            },
            "norm": self.ones(h),
        }

    def vae(self, cfg: VAEConfig):
        f32 = torch.float32

        def conv(k, cin, cout, bias=True):
            p = {"w": self.normal((k, cin, cout), 1.0 / math.sqrt(k * cin))}
            if bias:
                p["b"] = self.zeros(cout, dtype=f32)
            return p

        def snake_p(c):
            return {"alpha": self.zeros(c, dtype=f32), "beta": self.zeros(c, dtype=f32)}

        def res(c):
            return {"snake1": snake_p(c), "conv1": conv(7, c, c),
                    "snake2": snake_p(c), "conv2": conv(1, c, c)}

        eh, ch = cfg.encoder_hidden_size, cfg.decoder_channels
        cm = (1,) + tuple(cfg.channel_multiples)
        enc_blocks = [{"res1": res(eh * cm[i]), "res2": res(eh * cm[i]), "res3": res(eh * cm[i]),
                       "snake1": snake_p(eh * cm[i]),
                       "conv1": conv(2 * s, eh * cm[i], eh * cm[i + 1])}
                      for i, s in enumerate(cfg.downsampling_ratios)]
        strides = cfg.upsampling_ratios
        dec_blocks = []
        for i, s in enumerate(strides):
            cin, cout = ch * cm[len(strides) - i], ch * cm[len(strides) - i - 1]
            dec_blocks.append({"snake1": snake_p(cin), "conv_t1": conv(2 * s, cin, cout),
                               "res1": res(cout), "res2": res(cout), "res3": res(cout)})
        return {
            "encoder": {"conv1": conv(7, cfg.audio_channels, eh), "blocks": enc_blocks,
                        "snake1": snake_p(eh * cm[-1]), "conv2": conv(3, eh * cm[-1], eh)},
            "decoder": {"conv1": conv(7, cfg.decoder_input_channels, ch * cm[-1]),
                        "blocks": dec_blocks, "snake1": snake_p(ch),
                        "conv2": conv(7, ch, cfg.audio_channels, bias=False)},
        }
