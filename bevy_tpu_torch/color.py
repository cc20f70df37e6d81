"""Color conversions (port of bevy_tpu/color.py): the sRGB encode used at
readback and the decode of sRGB-authored colours and textures. All
rendering math is linear RGBA float32."""

from __future__ import annotations

import torch


def linear_to_srgb(c):
    """Per-channel sRGB OETF (ref: Srgba::gamma_function)."""
    c = torch.clamp(c.to(torch.float32), 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


def image_to_srgb_u8(img):
    """(H, W, 4) linear f32 -> (H, W, 4) sRGB u8 (the swapchain-encode
    position)."""
    rgb = linear_to_srgb(img[..., :3])
    a = torch.clamp(img[..., 3:4], 0.0, 1.0)
    out = torch.cat([rgb, a], dim=-1)
    return torch.round(out * 255.0).to(torch.uint8)


def srgb_to_linear(c):
    """Per-channel sRGB EOTF (ref: Srgba::gamma_function_inverse). Takes
    a tensor, or numpy/sequence values (then returns a CPU tensor)."""
    c = torch.as_tensor(c, dtype=torch.float32)
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def srgba(r, g, b, a=1.0):
    """sRGB-encoded colour -> linear RGBA (4,) f32 CPU tensor (ref:
    Color::srgb)."""
    rgb = srgb_to_linear(torch.tensor([r, g, b], dtype=torch.float32))
    return torch.cat([rgb, torch.tensor([a], dtype=torch.float32)])
