"""VQ-VAE image tokenizer (counterpart of neko_tpu/models/vq.py): a small
convolutional VQ-VAE with an EMA codebook that maps an image to a grid of
integer codes,

    [B, H, W, C] float -> encode_indices -> [B, h*w] int32 codes < codebook_size

and back through `decode_indices`.  Wrapping an image env with
`envs/vq_wrapper.VQObservationWrapper` turns its observations into a
MultiDiscrete space the control task trains on (one discrete token per grid
cell), so a model trained with --observation_loss predicts frames: a world
model (`examples/world_model.py`).

Images are [B, H, W, C] at the API, as in the JAX package; the convolutions
run NCHW inside.  Submodules carry the flax names (`encoder.Conv_0..3`,
`decoder.Conv_0, ConvTranspose_0, ConvTranspose_1, Conv_1`), and
`convert.jax_vq_variables_to_state_dict` maps neko_tpu's variables here.
Three places where torch's defaults differ from flax's:

* a `padding="SAME"` convolution pads as lax does, `total // 2` before and
  the rest after (`_same_pads`): a stride-2 convolution of an odd side pads
  (1, 2), never torch's symmetric padding, and the grid of an H x W image is
  ceil(H / 4) x ceil(W / 4) (`VQImageCodec.grid_for` rounds up too);
* flax's `ConvTranspose(padding="SAME")` (transpose_kernel=False) is a
  correlation over the input dilated by 2 and padded (2, 2), the kernel not
  flipped: `nn.ConvTranspose2d(padding=1)` with the HWIO kernel flipped in
  both spatial axes and stored [in, out, kh, kw] (the converter does both);
* flax's `nn.gelu` is the tanh approximation (`ops/gelu.gelu_tanh`).

The codebook (`embedding` [K, D], `cluster_size` [K], `cluster_sum` [K, D])
lives in registered buffers and trains by EMA cluster statistics without a
gradient; the straight-through estimator carries the reconstruction's
gradient to the encoder, and a code whose EMA count falls below 1e-3 restarts
from an encoding of the batch, drawn from the step's `torch.Generator` (the
JAX package draws with `jax.random.randint`: the rows differ, the rule is
the same).

Precision: everything runs in fp32 IEEE.  `fp32_math` switches TF32 off for
the convolutions (cuDNN uses it by default) and the matmuls for the duration
of a call, because the nearest code, argmax(2 z.e - |e|^2), flips under TF32
rounding; the codes are then those of the CPU up to summation order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neko_tpu_torch.ops.gelu import gelu_tanh


@dataclasses.dataclass(frozen=True)
class VQConfig:
    codebook_size: int = 512
    code_dim: int = 64
    hidden: int = 64
    # two stride-2 convs: a H x W image -> (H/4) x (W/4) code grid
    downscale: int = 4
    commitment_cost: float = 0.25
    ema_decay: float = 0.99
    # channels of the input images
    channels: int = 3


@contextlib.contextmanager
def fp32_math():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block,
    restored after it."""
    matmul, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """lax's SAME padding of one side: out = ceil(size / s), total =
    max((out - 1) * s + k - size, 0), split total // 2 before."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax's default kernel init: a normal of variance 1 / fan_in truncated
    at two standard deviations (rescaled so the variance stays 1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class SameConv(nn.Conv2d):
    """flax `nn.Conv(features, (k, k), strides=(s, s), padding="SAME")` on
    NCHW: lax's asymmetric SAME padding, then a convolution without any."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x):
        (k, _), (s, _) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[2], k, s)
        left, right = _same_pads(x.shape[3], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class SameConvTranspose(nn.ConvTranspose2d):
    """flax `nn.ConvTranspose(features, (4, 4), strides=(2, 2),
    padding="SAME")`: H x W -> 2H x 2W.  Its weight is the flax kernel
    flipped in both spatial axes, [in, out, kh, kw]."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1)


class Encoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        c = cfg
        self.Conv_0 = SameConv(c.channels, c.hidden, 4, 2)
        self.Conv_1 = SameConv(c.hidden, c.hidden, 4, 2)
        self.Conv_2 = SameConv(c.hidden, c.hidden, 3)
        self.Conv_3 = SameConv(c.hidden, c.code_dim, 1)

    def forward(self, x):                                  # NCHW
        x = gelu_tanh(self.Conv_0(x))
        x = gelu_tanh(self.Conv_1(x))
        x = gelu_tanh(self.Conv_2(x))
        return self.Conv_3(x)                              # [B, D, h, w]


class Decoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        c = cfg
        self.Conv_0 = SameConv(c.code_dim, c.hidden, 3)
        self.ConvTranspose_0 = SameConvTranspose(c.hidden, c.hidden)
        self.ConvTranspose_1 = SameConvTranspose(c.hidden, c.hidden)
        self.Conv_1 = SameConv(c.hidden, c.channels, 3)

    def forward(self, z):                                  # NCHW
        x = gelu_tanh(self.Conv_0(z))
        x = gelu_tanh(self.ConvTranspose_0(x))
        x = gelu_tanh(self.ConvTranspose_1(x))
        return self.Conv_1(x)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class VQVAE(nn.Module):
    """Encoder + EMA-codebook quantizer + decoder; `seed` draws the initial
    weights and codebook (flax's initializers: lecun-normal kernels, zero
    biases, a codebook of normal(0, 0.1) rows)."""

    def __init__(self, cfg: VQConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kh, kw = m.kernel_size
                cin = m.in_channels
                _lecun_normal_(m.weight, cin * kh * kw, g)
                nn.init.zeros_(m.bias)
        emb = torch.randn(c.codebook_size, c.code_dim, generator=g) * 0.1
        self.register_buffer("embedding", emb)
        self.register_buffer("cluster_size", torch.ones(c.codebook_size))
        self.register_buffer("cluster_sum", emb.clone())

    def _nearest(self, flat: torch.Tensor) -> torch.Tensor:
        """argmin |z - e|^2 == argmax (2 z.e - |e|^2): one [N, K] matmul."""
        emb = self.embedding
        dots = flat @ emb.t()
        e2 = (emb * emb).sum(dim=1)[None, :]
        return torch.argmax(2.0 * dots - e2, dim=1)

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, idx: torch.Tensor,
                    generator: Optional[torch.Generator]) -> None:
        """The codebook's EMA step on this batch's encodings `flat` [N, D]
        and codes `idx`; a dead code restarts from a row of `flat` drawn
        from `generator`."""
        c = self.cfg
        one_hot = F.one_hot(idx, c.codebook_size).float()
        counts = one_hot.sum(dim=0)
        sums = one_hot.t() @ flat
        d = c.ema_decay
        new_size = self.cluster_size * d + counts * (1 - d)
        new_sum = self.cluster_sum * d + sums * (1 - d)
        dead = new_size < 1e-3
        pick = flat[torch.randint(0, flat.shape[0], (c.codebook_size,), generator=generator,
                                  device=flat.device)]
        new_emb = torch.where(dead[:, None], pick,
                              new_sum / torch.clamp(new_size, min=1e-6)[:, None])
        self.cluster_size.copy_(torch.where(dead, torch.ones_like(new_size), new_size))
        self.cluster_sum.copy_(torch.where(dead[:, None], pick, new_sum))
        self.embedding.copy_(new_emb)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """-> (recon [B, H, W, C], metrics {loss, recon_mse, commit,
        perplexity}).  In train mode the codebook's EMA statistics update
        from this batch (the quantization itself uses the codebook as it
        was) and dead codes restart from its encodings."""
        c = self.cfg
        with fp32_math():
            z = _nhwc(self.encoder(_nchw(images)))           # [B, h, w, D]
            B, h, w, D = z.shape
            flat = z.reshape(-1, D)
            with torch.no_grad():
                idx = self._nearest(flat)
            quant = self.embedding[idx].reshape(B, h, w, D)
            if train:
                self._ema_update(flat.detach(), idx, generator)
            # straight-through: the decoder sees quant, the encoder's grads pass
            st = z + (quant - z).detach()
            recon = _nhwc(self.decoder(_nchw(st)))
        commit = torch.mean((z - quant) ** 2)
        recon_err = torch.mean((recon - images) ** 2)
        p = torch.bincount(idx, minlength=c.codebook_size).float() / idx.shape[0]
        perplexity = torch.exp(-torch.sum(p * torch.log(p + 1e-10)))
        loss = recon_err + c.commitment_cost * commit
        return recon, {"loss": loss, "recon_mse": recon_err, "commit": commit,
                       "perplexity": perplexity}

    @torch.no_grad()
    def encode_indices(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> int32 [B, h*w] codes."""
        with fp32_math():
            z = self.encoder(_nchw(images))
            B, D, h, w = z.shape
            idx = self._nearest(_nhwc(z).reshape(-1, D))
        return idx.reshape(B, h * w).to(torch.int32)

    @torch.no_grad()
    def decode_indices(self, idx: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        """int [B, h*w] -> reconstructed images [B, H, W, C]."""
        h, w = grid
        z = self.embedding[idx.reshape(-1).long()].reshape(idx.shape[0], h, w,
                                                           self.cfg.code_dim)
        with fp32_math():
            return _nhwc(self.decoder(_nchw(z)))


def adam(model: VQVAE, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)` over the model's parameters (b1 0.9, b2 0.999, eps
    1e-8 added after the square root; the codebook buffers are not in it)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: VQVAE, optimizer: torch.optim.Optimizer):
    """One VQ-VAE train step (the JAX package's `make_train_step`):
    step(images, generator) -> metrics; the parameters (by `optimizer`) and
    the codebook (by EMA) update in place.  `generator` draws the dead-code
    restarts; images lie on the model's device."""

    def step(images: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        _, metrics = model(images, train=True, generator=generator)
        metrics["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
