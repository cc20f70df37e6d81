"""Raster and shade ops (port of bevy_tpu.ops): plain PyTorch around the
hand-written CUDA kernels of `csrc/` (B1-B6), each behind a wrapper that
names its kernel and keeps a plain PyTorch version beside it."""
