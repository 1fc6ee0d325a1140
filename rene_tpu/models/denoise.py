"""AOV-guided denoisers, replacing the reference's OptiX/OIDN FFI hooks
(rene/src/main.rs:1812-1911). Two backends, both running on the same device
as the renderer:

* `atrous_denoise` — edge-avoiding à-trous wavelet filtering (Dammertz et
  al. 2010, the SVGF building block), guided by the normal and albedo AOVs
  the integrators write at bounce 0. Deterministic, no weights (stencil
  ops that XLA fuses into a handful of passes).
* `UNetDenoiser` — a small flax U-Net predicting a color residual OVER
  the à-trous output from (noisy, à-trous, normal, albedo). The final
  conv is zero-initialized, so the untrained net reproduces à-trous
  exactly and training can only improve on it (on the training
  distribution) — the property that makes `--denoiser cnn` a safe
  default. Train with rene_tpu.models.train_denoiser.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np


@functools.lru_cache(maxsize=8)
def _atrous_fn(iterations, sigma_color, sigma_normal, sigma_albedo):
    """Jitted à-trous pass, cached per parameter set (one compile per
    film shape instead of one per call)."""
    import jax
    import jax.numpy as jnp

    kernel = jnp.asarray([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16])
    offsets = [-2, -1, 0, 1, 2]

    @jax.jit
    def run(c, n, a):
        def one_pass(c, step):
            h, w, _ = c.shape
            acc = jnp.zeros_like(c)
            wsum = jnp.zeros((h, w, 1), c.dtype)
            for dy, ky in zip(offsets, kernel):
                for dx, kx in zip(offsets, kernel):
                    sy = dy * step
                    sx = dx * step
                    cc = jnp.roll(c, (-sy, -sx), axis=(0, 1))
                    nn = jnp.roll(n, (-sy, -sx), axis=(0, 1))
                    aa = jnp.roll(a, (-sy, -sx), axis=(0, 1))
                    dc = jnp.sum((c - cc) ** 2, axis=-1, keepdims=True)
                    dn = jnp.sum((n - nn) ** 2, axis=-1, keepdims=True)
                    da = jnp.sum((a - aa) ** 2, axis=-1, keepdims=True)
                    wgt = (ky * kx) * jnp.exp(-dc * sigma_color
                                              - dn * sigma_normal
                                              - da * sigma_albedo)
                    acc = acc + wgt * cc
                    wsum = wsum + wgt
            return acc / jnp.maximum(wsum, 1e-8)

        for i in range(iterations):
            c = one_pass(c, 1 << i)
        return c

    return run


def atrous_denoise(color, normal, albedo, iterations: int = 5,
                   sigma_color: float = 4.0, sigma_normal: float = 128.0,
                   sigma_albedo: float = 8.0):
    """Edge-avoiding à-trous wavelet denoise. Inputs (H,W,3) float arrays."""
    import jax.numpy as jnp
    run = _atrous_fn(iterations, sigma_color, sigma_normal, sigma_albedo)
    return np.asarray(run(jnp.asarray(color), jnp.asarray(normal),
                          jnp.asarray(albedo)))


# ---------------------------------------------------------------------------
# Learned denoiser (flax U-Net scaffold)
# ---------------------------------------------------------------------------

def _flax_linen():
    try:
        import flax.linen as nn
    except ImportError as e:
        raise ImportError("the U-Net denoiser (--denoiser cnn) needs the "
                          "'flax' package, which is not installed; "
                          "--denoiser atrous runs without it") from e
    return nn


def _flax_serialization():
    _flax_linen()
    import flax.serialization as ser
    return ser


def conv3x3(x, kernel):
    """3x3 SAME convolution of NHWC `x` with an HWIO `kernel`, at
    `lax.Precision.HIGHEST` (full float32 products; a GPU would otherwise
    be free to run it in TF32)."""
    import jax
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


class UNetDenoiser:
    """Small U-Net over (noisy, à-trous base, normal, albedo) predicting a
    residual added to the à-trous base."""

    def __init__(self, features: int = 24, levels: int = 3):
        nn = _flax_linen()
        import jax.numpy as jnp

        class Conv3(nn.Module):
            """3x3 SAME convolution, HWIO kernel (parameter names and
            shapes of nn.Conv, so the shipped weights load unchanged)."""
            ch: int
            kernel_init = staticmethod(nn.initializers.lecun_normal())

            @nn.compact
            def __call__(self, x):
                k = self.param("kernel", self.kernel_init,
                               (3, 3, x.shape[-1], self.ch))
                b = self.param("bias", nn.initializers.zeros, (self.ch,))
                return conv3x3(x, k) + b

        class ConvZero(Conv3):
            """Conv3 with a zero-init kernel (the residual head)."""
            kernel_init = staticmethod(nn.initializers.zeros)

        class Block(nn.Module):
            ch: int

            @nn.compact
            def __call__(self, x):
                # explicit nn.Conv-style names keep the param pytree
                # compatible with weights trained under nn.Conv
                x = Conv3(self.ch, name="Conv_0")(x)
                x = nn.silu(x)
                x = Conv3(self.ch, name="Conv_1")(x)
                return nn.silu(x)

        class UNet(nn.Module):
            feats: int
            levels: int

            @nn.compact
            def __call__(self, x):
                skips = []
                h = x
                for l in range(self.levels):
                    h = Block(self.feats << l)(h)
                    skips.append(h)
                    h = nn.avg_pool(h, (2, 2), strides=(2, 2))
                h = Block(self.feats << self.levels)(h)
                for l in reversed(range(self.levels)):
                    sh = skips[l].shape
                    h = jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2)
                    h = h[:, :sh[1], :sh[2]]
                    # odd skip sizes: avg_pool floors (45 -> 22), so the
                    # upsample comes back one short (44); edge-pad up.
                    # No-op for pool-divisible films, so trained weights
                    # are unaffected.
                    h = jnp.pad(h, ((0, 0), (0, sh[1] - h.shape[1]),
                                    (0, sh[2] - h.shape[2]), (0, 0)),
                                mode="edge")
                    h = jnp.concatenate([h, skips[l]], axis=-1)
                    h = Block(self.feats << l)(h)
                return ConvZero(3, name="Conv_0")(h)

        self.module = UNet(features, levels)
        self.features = features
        self.levels = levels
        self.params = None

    def save(self, path: str):
        """Persist params (flax msgpack) with the net shape prefixed."""
        import os
        ser = _flax_serialization()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(bytes([self.features, self.levels]))
            f.write(ser.to_bytes(self.params))

    @classmethod
    def load(cls, path: str) -> "UNetDenoiser":
        import jax
        ser = _flax_serialization()
        with open(path, "rb") as f:
            head = f.read(2)
            blob = f.read()
        net = cls(features=head[0], levels=head[1])
        template = net.init(jax.random.PRNGKey(0))
        net.params = ser.from_bytes(template, blob)
        return net

    def init(self, rng_key, height=64, width=64):
        import jax.numpy as jnp
        x = jnp.zeros((1, height, width, 12), jnp.float32)
        self.params = self.module.init(rng_key, x)["params"]
        return self.params

    def __call__(self, color, normal, albedo, base=None):
        """Denoise one film; `base` is the à-trous output (computed here
        when not supplied)."""
        import jax
        import jax.numpy as jnp
        if self.params is None:
            self.init(jax.random.PRNGKey(0), color.shape[0], color.shape[1])
        if base is None:
            base = atrous_denoise(color, normal, albedo)
        x = jnp.concatenate([jnp.asarray(color), jnp.asarray(base),
                             jnp.asarray(normal), jnp.asarray(albedo)],
                            axis=-1)[None]
        residual = self.module.apply({"params": self.params}, x)[0]
        # zero-init last conv: equals the a-trous base until trained
        return np.asarray(jnp.asarray(base) + residual)

    def train_step(self, params, opt_state, optimizer, noisy, normal,
                   albedo, clean, base):
        """One optimizer step on an L1 loss; returns (params, opt_state,
        loss)."""
        import jax
        import jax.numpy as jnp

        def loss_fn(p):
            x = jnp.concatenate([noisy, base, normal, albedo], axis=-1)
            pred = base + self.module.apply({"params": p}, x)
            return jnp.mean(jnp.abs(pred - clean))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss


def denoise(color, normal, albedo, method: str = "atrous",
            unet: Optional[UNetDenoiser] = None, varmean=None):
    """varmean: per-pixel variance of the color mean (render want_var).
    When given, the output is the convergence-aware blend — a converged
    render passes through unchanged, so denoising can never regress a
    high-spp image (the round-4 quality sweep found cnn LOSING to raw
    on 3 of 5 converged goldens; the reference's denoisers are optional
    post-passes, rene/src/main.rs:1625-1647 — ours must never hurt)."""
    if method in ("none", None):
        return color
    if method == "atrous":
        den = atrous_denoise(color, normal, albedo)
    elif method == "cnn":
        den = (unet or UNetDenoiser())(color, normal, albedo)
    else:
        raise ValueError(f"unknown denoiser {method}")
    if varmean is None:
        return den
    return convergence_blend(color, den, varmean)


def convergence_blend(raw, den, varmean, knee: float = 0.03):
    """Per-pixel Wiener-style shrink of the denoised image toward the
    raw estimate: w = v / (v + (knee*signal)^2), where v is the
    variance of the raw MEAN and signal is local luma. Noisy pixels
    (relative std >> knee) take the denoiser; converged pixels keep the
    unbiased raw value. The weight map is box-smoothed so speckled
    variance estimates don't punch holes in smooth denoised regions."""
    import numpy as np
    raw = np.asarray(raw, np.float32)
    den = np.asarray(den, np.float32)
    lum = np.asarray(varmean, np.float32) @ np.float32([0.299, 0.587,
                                                        0.114])
    sig = raw @ np.float32([0.299, 0.587, 0.114])
    floor = np.float32(max(np.mean(sig) * 0.05, 1e-6))
    w = lum / (lum + (knee * np.maximum(sig, floor)) ** 2)
    w = np.nan_to_num(w, nan=1.0, posinf=1.0)  # inf var (1 chunk) -> 1
    for _ in range(2):  # 3x3 box smoothing, edge-replicated
        p = np.pad(w, 1, mode="edge")
        w = sum(p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    return raw + w[..., None] * (den - raw)
