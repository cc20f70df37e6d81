"""Raster ops (port of bevy_tpu.ops): plain PyTorch around the two
hand-written CUDA kernels (B1 `raster3d_splat.fused_eval_composite`, B2
`raster3d_visbuf.raster_visbuf`)."""
