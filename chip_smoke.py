"""Smoke run of the bevy_tpu_torch main path on one CUDA card.

    python3 chip_smoke.py

(`python3 chip_smoke.py --a8-only` builds and runs phases 37-38 alone,
`--a7-only` phase 39 alone, printing no result line.) Builds the CUDA kernels from
`bevy_tpu_torch/csrc/` (one nvcc process a source, all started together),
then:
1. holds the window-splat (B1) and streaming-tile (B2) kernels against
   their plain PyTorch versions, bit for bit, on a scene with both window
   classes and on one with giant and near-plane clusters, and B1 on four
   scenes that stress its cull (tests/torch_scenes.py b1_cull_scenes:
   slivers across tile and frame edges; random planes with zeros,
   infinities and NaNs over some negative depths; 40 slots over 256- and
   1200-row windows), with B1's and B2's cull counts for every call;
   B2's scissor instantiation on the near-plane scene's calls with a rect
   that cuts tiles; and B2, the scissor off and on, on two more scenes
   (tests/torch_scenes.py b2_scenes: slivers; straddlers in a frame 202
   wide, list walks of three passes);
2. renders the many_cubes twin at the golden configuration (300 cubes,
   320x180, 2 frames) and compares it with tests/goldens/cubes_splat_f2.png
   (under 1% of pixels may drift by more than 8);
3. runs the full-size many_cubes frame (160,000 cubes, 1280x720), times 20
   frames with CUDA events and checks both kernels were launched;
4. holds both of the full-size frame's B1 calls (the two window classes)
   against plain, bit for bit, with their cull counts and the share of
   window pixels in the owner's screen box, and times B1 (each class) and
   B2 (with its cull counts) against their plain versions at the
   full-size shapes;
5. renders the many_lights twin at the golden configuration (48 lights,
   256x144, 1 frame) against tests/goldens/lights_f1.png, holding B1 and
   B2 (bit for bit) and the deferred shade B3 (rtol 1e-5, atol 1e-5, the
   count of differing values printed) against their plain versions on
   every call, with B2's and B3's cull counts;
6. shades a small scene with spot and rect lights, clearcoat and a
   non-default reflectance (the other B3 instantiations), and the same
   inputs without rect (the culled spot instantiation), B3 against plain,
   with B3's cull counts;
7. runs the full-size many_lights frame (100,000 point lights, 1,024 cubes
   and the floor, 1280x720), times 20 frames with CUDA events, checks B1, B2
   and B3 were launched (B3 once a frame), that light_pair_overflow and the
   mesh pass's own tile overflow are 0;
8. holds B1 and B2 (bit for bit) against their plain versions on every call
   of one full-size many_lights frame, with B2's cull counts, and times B3 against its plain
   version at that frame's shapes, with B3's cull counts and its bound
   (recounted, the old figure beside it);
9. holds the tile sprite raster (B4) against its plain version, bit for
   bit, with its cull counts, on the CPU test scenes moved to the card
   (f32 bilinear and nearest, bf16, rotated solid, a max_visible
   overflow, an overflowing tile);
10. renders the breakout twin at the golden configuration (320x200, 25
   frames) against tests/goldens/breakout_f25.png, holding B4 against
   plain on every call;
11. runs many_sprites at full size (100,000 sprites, 1280x720), times 20
   frames with CUDA events, checks B4 was launched once a frame and that
   pair_overflow and visible_overflow are 0 (tile_overflow, the true
   count, is printed), and holds B4 against plain on every call of 20
   more frames;
12. holds the window-splat sprite raster (B5) against its plain version,
   bit for bit, with its cull counts, on all 16 (bilinear, rotated,
   alpha_only, f32/bf16) variants, on sprites straddling its warps'
   32-column boundaries (rotated and not), and on tall, equal-z and
   opaque-wall scenes;
13. runs bevymark at full size (1280x720): 150 frames build the flock,
   then 20 frames are timed; checks the bird count against the spawn
   budget arithmetic, that B5 was launched once a frame and that
   pair_overflow and visible_overflow are 0;
14. times B4 (a many_sprites frame, with its cull counts) and B5 (a
   bevymark frame) against their plain versions at full size, each kernel
   bit-equal to plain there;
15. holds the window composite (B6) against its plain version, bit for bit,
   with its pixel counts, on a scene of overlapping, tying windows, on the
   same windows over incoming depths below 0, and on every call of the
   cluster-sharded flat raster (the scene of tests/test_sharded_raster.py,
   8 shards, all on the one card), whose image must equal the one-shard
   image;
16. renders the many_cubes twin with 8 shards and without at the
   configuration of tests/test_sharded_cubes.py: identical images, B6 against
   plain on every call;
17. runs the full-size many_cubes frame with 4 shards, times 20 frames with
   CUDA events, checks B6 was launched 2 window classes x 4 shards a frame
   and that pair_overflow counts nothing but the fallback clusters (the
   sharded path does not draw them: no window is dropped), prints the
   pixels that differ from the unsharded frame, holds every B6 call of
   one more frame against plain with its pixel counts, and times B6
   against its plain version and one scatter_reduce_ call (and the other
   window class's largest call);
18. renders the many_lights golden configuration with a 4-band shade:
   against tests/goldens/lights_f1.png, identical to the unsharded image,
   B1/B2/B3 against plain on every call;
19. runs the full-size many_lights frame with a 4-band shade, times 20
   frames, checks B3 was launched 4 times a frame, holds each band's B3
   call of one frame against plain (rtol/atol 1e-5) with its cull counts
   (each band's row offset in params[34]), prints the overflows, and checks
   the image equals the unsharded frame's;
20. holds the per-tile triangle raster against its plain version, bit for
   bit, in all six instantiations (B7 corners, B8 planes and planes_gbuf,
   scissor off and on) on the scene of tests/test_torch_tris.py with two
   slivers added (SLIVER_CORNERS: their float edges read a pixel inside
   past their AABB), with B7's and B8's cull counts;
21. renders the many_cubes twin through the general route
   (`backend="xla"`, 300 cubes, 320x180, 3 frames) against
   tests/goldens/cubes_f3.png, B7 against plain on every call, with B7's
   cull counts;
22. renders the 3d_shapes twin (320x180, 1 frame) against
   tests/goldens/shapes_f1.png, B7 against plain, with B7's cull counts;
23. runs many_cubes 160k through the general route at 1280x720 (20 frames
   timed, B7 once a frame, overflows printed), times B7 against its plain
   version at that frame's shapes, with B7's cull counts and its bound
   (recounted, the old figure beside it), and runs 3d_shapes at 1280x720
   (20 frames timed);
24. calls raster_batched_legacy forward and deferred (a 19-plane G-buffer)
   on the 160k cubes' clip-space corners and normals at 1280x720
   (tile_h=16, max_per_tile=3072): B8 twice, each bit-equal to plain, with
   its cull counts, the calls and B8 timed beside its bound, overflows
   printed;
25. renders the many_foxes twin at the golden configuration (9 foxes,
   256x144, 8 frames) against tests/goldens/foxes_f8.png, B1 (twice a
   frame) and B2 (once) bit-equal to plain on every call, overflows 0;
26. runs the full-size many_foxes frame (1,000 skinned, animated foxes,
   1280x720), times 20 frames with CUDA events, checks B1 was launched
   twice a frame, B2 once and no other kernel, prints the overflows,
   holds one frame's B1 and B2 calls against plain with their cull
   counts, times each against its plain version and its bound at the fox
   frame's shapes, and profiles 10 frames by span (skin:*, mesh:*);
27. renders the group route's shade-record worlds
   (tests/torch_scenes.py shade_record_world: "atlas" — textured,
   normal-mapped, parallax-occlusion, channel-textured, lightmapped and
   uv-transformed cubes; "smooth" — smooth spheres) on the card and on
   the CPU: the two images under the golden rule, B1 and B2 bit-equal to
   plain on every call;
28. renders the shadow showcase (examples/torch_shadow_showcase.py) small
   (160x96, 4 cascades, the spot map, 6 point faces, all 256^2, a 4 x 4
   grid, casters across the spot's and the point light's near planes) on
   the card and on the CPU: the two images under the golden rule, B1 and
   B2 bit-equal to plain on every call, B3 (the shadow plane, the
   anisotropic and tinted variant) within rtol/atol 1e-5;
29. runs the full-size shadow world (1280x720, a 100 x 100 grid of cube
   casters, 4 x 2048^2 cascades, a 1024^2 spot map, 6 x 1024^2 point
   faces: 11 depth-only passes and the G-buffer pass a frame over two
   mesh groups), times 20 frames with CUDA events, checks 48 B1, 24 B2
   and 1 B3 launches a frame and no other kernel, that pair_overflow,
   tile_overflow and light_pair_overflow are 0, and holds every B1 and B2
   call of one frame (every map) against plain, bit for bit;
30. times B1 and B2 (each one's busiest call on a 2048^2 cascade and on
   a 1024^2 spot / point map) against plain and their bounds, with their
   cull counts, and B3
   with the shadow plane and the tint + anisotropy variant, profiles
   10 frames by span (shadow:*, mesh:*, lights:*), then moves the two
   near-plane casters out of the lights' views and checks that the
   1024^2 B2 calls list fewer (tile, cluster) entries without them: the
   straddlers reach B2 inside the spot and point passes, in calls held
   bit-equal in phase 29;
31. renders the small 2D frames on the card and on the CPU (the
   examples/torch_*.py twins text2d, sprite_sheet, tilemap across its
   tile edit, 2d_gizmos, split_screen_2d at 640x360 in tiles and splat
   mode; tests/torch_scenes.py text_world: a DigitText counter and rich
   text, gizmo_world: 2D, 3D and retained gizmos with stroke text,
   slice_world: 9-slice and tiled sprites): the two images under the
   golden rule, every B4 (sprite and gizmo pass) and B5 call bit-equal to
   plain, with the block / warp cull counts summed over the calls and 0
   dropped but covered;
32. runs many_text2d at 1280x720 (the JAX example's scene at its density:
   480 labels, about 2,200 glyph sprites), in tiles and in splat mode:
   20 frames timed, B4 (or B5) once a frame and no other kernel, the
   overflows 0, one frame's call bit-equal to plain with its cull counts,
   its device time beside its bound, and 5 frames profiled (tiles);
33. runs many_gizmos at 1280x720 (16,000 lines a frame): 20 frames timed,
   B4 twice a frame (the sprite and the gizmo pass) and no other kernel,
   the gizmo overflows 0, both calls of one frame bit-equal to plain with
   their cull counts, the gizmo pass's call timed (events, device, plain)
   beside its bound, 5 frames profiled;
34. runs split_screen_2d at 1280x720 (two cameras), in tiles and in splat
   mode: 20 frames timed, B4 (or B5) once a camera a frame and no other
   kernel, the overflows 0, both calls of one frame bit-equal to plain,
   5 frames profiled (tiles);
35. renders the screen-pass worlds of tests/torch_scenes.py small
   (post_world: SSAO, bloom, depth of field, CAS, FXAA, ACES; aa_world
   "taa": motion vectors + TAA over 3 frames, "ssaa": a 2 x 2 grid;
   fog_world: distance + volumetric fog; ssr_world: deferred + SSR) on
   the card against the JAX package's stored images (tests/goldens/
   post_f1, taa_f3, ssaa2_f1, fog_f1, ssr_f1, the golden rule) and the
   port on the CPU, the TAA world's motion planes against
   taa_f3_motion.npz, B1 and B2 bit-equal and B3 within rtol/atol 1e-5 on
   every call, the overflows 0;
36. runs each 3D screen-pass twin (examples/torch_post_processing.py,
   torch_anti_aliasing.py in taa, smaa and ssaa mode, torch_auto_exposure_
   demo.py, torch_depth_of_field.py, torch_motion_blur_demo.py,
   torch_fog_3d.py with and without shadow maps, torch_3d_scene.py with
   the skybox and the atmosphere, torch_pbr_materials.py,
   torch_ssr_demo.py with contact shadows, torch_irradiance_volumes.py,
   torch_decals.py, torch_wireframe.py) at 1280x720: 10 frames timed,
   its kernels launched (B1 every frame, B3 on the deferred ones, B4 in
   the wireframe's gizmo pass) and no other, the overflows 0, every B1,
   B2, B3 and B4 call of one frame against plain, and 3 frames profiled
   for the kernel launches a frame, the busy share and the time by
   system;
37. holds B1's scissor instantiation against its plain version, bit for
   bit, on the cull scenes (tests/torch_scenes.py b1_cull_scenes, quad
   records included) under a rect that cuts windows, blocks and tiles,
   with its cull counts under the rect (0 dropped pairs that could
   write); renders the split-screen worlds (tests/torch_scenes.py
   split_world: tests/test_viewport.py's two cameras, with RenderLayers,
   and examples/split_screen.py's four) on the group route and the
   general route, and the slice's other stored small frames (OIT,
   transmission, custom and extended materials, depth bias, occlusion
   over 3 frames, the BVH cull, LOD chains, the cluster DAG, the smooth
   shade-record world) against the JAX package's images (the golden
   rule), every B1, B2 and B7 call bit-equal to plain, the overflows 0,
   and counts the Memcpy DtoH records of one two-camera frame;
38. runs the split-screen twin (examples/torch_split_screen.py, four
   cameras) at 1280x720: 10 frames timed, B1 twice and B2 once a camera
   and mesh group and no other kernel, every call of a frame bit-equal
   to plain (B1 with its scissor), the busiest scissored B1 call timed
   against plain and its bound (the kernels line's B1 "scissor" entry),
   the Memcpy DtoH records of a frame, a 3-frame profile; many_cubes 160k
   with occlusion_cull (phase_budget 160,000) and without: ms/frame,
   launches, pair_overflow 0, the two frames under the golden rule,
   every B1 / B2 call of an occlusion frame bit-equal, a profile; the
   BVH scene at 1280x720 (identical to the unculled frame) and the DAG
   scene (under the JAX test's bound of full detail); and the OIT,
   transmission and custom-material twins (transparency_3d, blend_modes,
   glass_and_coat, shader_material): 10 frames timed, launches,
   overflows 0, every B1 / B2 call of a frame bit-equal, a profile;
39. the ECS and app core (A7a): (a) each ECS twin (examples/torch_<name>.py
   for run_conditions, change_detection, removal_detection,
   component_hooks, observer_propagation, one_shot_systems, states,
   sub_states, computed_states, system_stepping, ecs_hierarchy,
   many_components, message_events, startup_systems) runs its 5 scripted
   frames on the card and on the CPU: the whole world state (every
   component column and tick, resource, message and event buffer, each
   system's last run and Local store, tick, frame) equal (ints and bools
   exactly, floats within 1e-5); 20 more frames profiled: kernel
   launches and Memcpy DtoH records a frame, 0 for the device-tier twins
   (run_conditions, states, computed_states, change_detection,
   observer_propagation); (b) alien_cake_addict
   (examples/torch_alien_cake_addict.py) at 1280x720 on the group route:
   240 frames of the scripted chase, each frame through InputPlugin's
   frame inputs, the game's host systems and the mesh pass; its
   trajectory (player cell, cake cell, score a frame) equal to the port's
   CPU run at 128x80, the score above 0, every B1 and B2 call of every
   frame bit-equal to plain, pair_overflow 0; then 240 more frames timed
   one by one with CUDA events (median and spread), B1 / B2 launches a
   frame, the Memcpy DtoH records a frame over 3 frames and a 3-frame
   profile (busy share).

The shards of phases 15-19 all sit on the one card (a ShardMesh may repeat
a device): their work runs one shard after another.

Each kernel's bound (the least time the card could take for the same work:
the larger of its bytes over 3.35 TB/s and its FP32 operations over 67
TFLOP/s, counted from this run's inputs: for B1 the edge and depth tests
over the (pixel, slot) pairs inside the edges; for B3 the light body over
the contributing pairs, win > 0; for B4 and B5 the coverage, blend and
sample of the covered (pixel, sprite / window) pairs; for B7/B8 the edge and depth tests
over the pairs inside the edges, and the record fields each triangle
needs by what it does: its edges if listed, its depth if inside at some
pixel, its shade if it wins one) is printed beside its time, with the
old count (the reference's walk of every listed pair, whole records)
beside it and every kernel's time before its redesign
(BEFORE_REDESIGN_MS). Device times: 20 calls queued behind a spin kernel
between CUDA events (device_ms), with torch.profiler's split by kernel.

The culls' counts: the (pixel, slot / light / sprite / window /
triangle) pairs the reference's walk reaches, the pairs the kernel's cull
keeps (replayed by `raster3d_splat.window_px_kept`,
`raster3d_visbuf.tri_in_stream_block`, `shade.light_in_block`,
`raster2d.sprite_in_block`, `raster2d_splat.sprite_in_warp`,
`raster3d_tris.tri_in_block` and `plane_in_block`: the same decisions in
plain PyTorch, not read back from the kernel), the pairs that could
write (B1: inside the edges, z above the depth), contribute (B3: win >
0), are covered (B4, B5) or are inside the edges (B2, B7, B8), and the
pairs the cull drops that would have, which must be 0 (asserted). B6's
counts: the valid windows' in-frame pixels read, those not empty, those
it loads a depth for and those that beat the depth.

The last three lines of standard output are a JSON object of kernel
results, the card's name and power limit (nvidia-smi), and the card's
result line. Any failure raises; there is no CPU fallback.
"""

from __future__ import annotations

import json
import re
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "cubes_splat_f2.png"
LIGHTS_GOLDEN = ROOT / "tests" / "goldens" / "lights_f1.png"
LIGHTS_GOLDEN_KW = dict(n_lights=48, n_cubes=16, width=256, height=144,
                        capacity=256, camera=(0.0, 9.0, 22.0))
KERNELS = {
    "B1": ("fused_eval_composite", "bevy_tpu_torch/csrc/splat_raster.cu",
           "bevy_tpu/ops/raster3d_splat.py:589"),
    "B2": ("raster_visbuf", "bevy_tpu_torch/csrc/stream_raster.cu",
           "bevy_tpu/ops/raster3d_visbuf.py:382"),
    "B3": ("deferred_shade", "bevy_tpu_torch/csrc/deferred_shade.cu",
           "bevy_tpu/ops/shade_pallas.py:99"),
    "B4": ("sprite_tiles", "bevy_tpu_torch/csrc/sprite_tiles.cu",
           "bevy_tpu/ops/raster2d_pallas.py:50"),
    "B5": ("sprite_splat", "bevy_tpu_torch/csrc/sprite_splat.cu",
           "bevy_tpu/ops/raster2d_splat.py:64"),
    "B6": ("composite_windows", "bevy_tpu_torch/csrc/window_composite.cu",
           "bevy_tpu/ops/raster3d_splat.py:511"),
    "B7": ("raster_tris", "bevy_tpu_torch/csrc/tri_raster.cu",
           "bevy_tpu/ops/raster3d_pallas.py:239"),
    "B8": ("raster_tris", "bevy_tpu_torch/csrc/tri_raster.cu",
           "bevy_tpu/ops/raster3d_pallas.py:106"),
}
BREAKOUT_GOLDEN = ROOT / "tests" / "goldens" / "breakout_f25.png"
FOX_GOLDEN = ROOT / "tests" / "goldens" / "foxes_f8.png"
FOX_GOLDEN_KW = dict(n_foxes=9, width=256, height=144, capacity=32,
                     camera=(0.0, 3.0, 10.0), camera_pitch=-0.25)
CUBES_XLA_GOLDEN = ROOT / "tests" / "goldens" / "cubes_f3.png"
SHAPES_GOLDEN = ROOT / "tests" / "goldens" / "shapes_f1.png"
BREAKOUT_GOLDEN_KW = dict(width=320, height=200, camera_scale=3.2,
                          ball_velocity=(120.0, 380.0))
FLOCK_FRAMES = 150         # bevymark frames that build the flock
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, FP32 outside the tensor cores
SHADE_TOL = dict(rtol=1e-5, atol=1e-5)
# the kernels' times before their redesign (PERF.md §6: NVIDIA H100 80GB
# HBM3, 700.00 W; B1: the device time of this script's full-height call,
# B3, B7: its events time, B5: the device time a frame of
# examples/torch_bevymark.py --profile 10, B2, B4, B6, B8: this script's
# device time, device_ms)
BEFORE_REDESIGN_MS = {"B1": 0.4144, "B2": 0.0200, "B3": 2.0329,
                      "B4": 0.1072, "B5": 0.5765, "B6": 0.1179,
                      "B7": 1.8988, "B8": 1.5958}


def log(*a):
    print(*a, flush=True)


def read_png_rgba8(path):
    """Decode an 8-bit RGBA, non-interlaced PNG (the goldens' format) with
    zlib alone, so the smoke run needs no imaging package."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 6, 0):
        raise ValueError(f"{path}: not 8-bit RGBA non-interlaced")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 4 * w)
    out = np.zeros((h, 4 * w), np.int32)
    prev = np.zeros(4 * w, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        cur = np.zeros(4 * w, np.int32)
        for x in range(4 * w):
            a = cur[x - 4] if x >= 4 else 0
            b = prev[x]
            c = prev[x - 4] if x >= 4 else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:                      # Paeth
                p0 = a + b - c
                pa, pb, pc = abs(p0 - a), abs(p0 - b), abs(p0 - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 4)


class Recorder:
    """Wraps the kernel entry points where the port's modules call them
    (mesh3d: B1, B2, and B7 / B8 — one wrapper, `raster_tris`, told apart
    by its layout; deferred and parallel/raster: B3; sprite and gizmos:
    B4, sprite: B5; parallel/raster: B6) to keep the arguments of every
    call (for the kernel-vs-plain comparisons), and the calling module's
    name of each (`origin`)."""

    def __init__(self):
        from bevy_tpu_torch.parallel import raster as par_raster
        from bevy_tpu_torch.render import deferred, gizmos, mesh3d, sprite
        self.sites = {"B1": (mesh3d,), "B2": (mesh3d,),
                      "B3": (deferred, par_raster), "B4": (sprite, gizmos),
                      "B5": (sprite,), "B6": (par_raster,),
                      "B7": (mesh3d,), "B8": (mesh3d,)}
        self.calls = {kid: [] for kid in self.sites}
        self.origin = {kid: [] for kid in self.sites}
        self.orig = {}
        for kid, mods in self.sites.items():
            for mod in mods:
                self.orig[(mod, KERNELS[kid][0])] = kernel_fn(kid)

    def __enter__(self):
        for (mod, name), fn in self.orig.items():
            def rec(*a, _f=fn, _m=mod.__name__.rsplit(".", 1)[-1], **kw):
                kid = kernel_id(_f, kw)
                self.calls[kid].append((a, kw))
                self.origin[kid].append(_m)
                return _f(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.orig.items():
            setattr(mod, name, fn)


def kernel_id(fn, kw):
    """The kernel id of a call to wrapper `fn` with keywords `kw`."""
    from bevy_tpu_torch.ops import raster3d_tris
    if fn is raster3d_tris.raster_tris:
        return raster3d_tris.KERNEL_OF[kw.get("layout", "corners")]
    return next(k for k in KERNELS if kernel_fn(k) is fn)


def plain_fn(kid):
    from bevy_tpu_torch.ops import (
        raster2d, raster2d_splat, raster3d_splat, raster3d_tris,
        raster3d_visbuf, shade)
    return {"B1": raster3d_splat._fused_plain,
            "B2": raster3d_visbuf._raster_visbuf_plain,
            "B3": shade._deferred_shade_plain,
            "B4": raster2d._sprite_tiles_plain,
            "B5": raster2d_splat._sprite_splat_plain,
            "B6": raster3d_splat._composite_plain,
            "B7": raster3d_tris._raster_tris_plain,
            "B8": raster3d_tris._raster_tris_plain}[kid]


def kernel_fn(kid):
    from bevy_tpu_torch.ops import (
        raster2d, raster2d_splat, raster3d_splat, raster3d_tris,
        raster3d_visbuf, shade)
    return {"B1": raster3d_splat.fused_eval_composite,
            "B2": raster3d_visbuf.raster_visbuf,
            "B3": shade.deferred_shade,
            "B4": raster2d.sprite_tiles,
            "B5": raster2d_splat.sprite_splat,
            "B6": raster3d_splat.composite_windows,
            "B7": raster3d_tris.raster_tris,
            "B8": raster3d_tris.raster_tris}[kid]


def reset_launches():
    tris = kernel_fn("B7").kernel_launches
    for kid in KERNELS:
        if kid in tris:
            tris[kid] = 0
        else:
            kernel_fn(kid).launches = 0


def read_launches():
    """Launches by kernel id (raster_tris counts B7 and B8 apart)."""
    tris = kernel_fn("B7").kernel_launches
    return {kid: tris[kid] if kid in tris else kernel_fn(kid).launches
            for kid in KERNELS}


def compare(kid, a, kw):
    """Kernel vs plain on one recorded call. B1/B2/B6: asserts bit equality
    of depth and winner; B7/B8: of the framebuffer (or G-buffer) and
    depth; B3: asserts rtol/atol SHADE_TOL; B4/B5: asserts bit equality of
    the framebuffer. Returns the max abs error (and, for B3, the max
    relative error)."""
    if kid in ("B4", "B5"):
        ck = kernel_fn(kid)(*a, **kw)
        cp = plain_fn(kid)(*a, **kw)
        torch.cuda.synchronize()
        err = float((ck - cp).abs().max())
        nd = int((ck.view(torch.int32) != cp.view(torch.int32)).sum())
        if nd:
            raise AssertionError(f"{kid} kernel != plain: {nd} values "
                                 f"differ (max abs err {err})")
        return err
    if kid == "B3":
        ck = kernel_fn(kid)(*a, **kw)
        cp = plain_fn(kid)(*a, **kw)
        torch.cuda.synchronize()
        err = float((ck - cp).abs().max())
        rel = float(((ck - cp).abs() / cp.abs().clamp(min=1e-6)).max())
        nd = int((ck != cp).sum())
        torch.testing.assert_close(ck, cp, **SHADE_TOL)
        return err, rel, nd
    dk, wk = kernel_fn(kid)(*a, **kw)
    dp, wp = plain_fn(kid)(*a, **kw)
    torch.cuda.synchronize()
    # over the values whose bits differ: an infinity in both reads 0, not
    # inf - inf = NaN
    err = max(float(torch.where(x.view(torch.int32) == y.view(torch.int32),
                                0.0, (x - y).abs()).max())
              for x, y in ((dk, dp), (wk, wp)))
    same = torch.equal(dk.view(torch.int32), dp.view(torch.int32)) and \
        torch.equal(wk.view(torch.int32), wp.view(torch.int32))
    if not same:
        nd = int((dk.view(torch.int32) != dp.view(torch.int32)).sum())
        nw = int((wk.view(torch.int32) != wp.view(torch.int32)).sum())
        raise AssertionError(f"{kid} kernel != plain: {nd} and {nw} values "
                             f"of the two outputs differ (max abs err "
                             f"{err})")
    return err


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, flops):
    """(bound ms, "bytes" or "operations") on one H100 SXM."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def work_b1(a, kw, aabb=None, chunk=1024):
    """(pixel, slot) pairs of one B1 call, over the valid windows'
    in-frame pixels: {"old": the reference's walk (every pixel of every
    window, every slot), "kept": those in the (tile, slot) pairs the
    kernel's cull keeps (raster3d_splat.window_px_kept's plain replay of
    it), "inside": kept pairs inside the slot's edges (the walk's
    arithmetic), "writing": pairs inside whose z beats the incoming depth
    (the pairs that can write), "dropped": writing pairs the cull drops
    (must be 0), "tiles": (window tile, slot) pairs kept / in the frame,
    "px": the windows' in-frame pixels, "in_kept": those in a tile with a
    kept slot, "in_box": those whose centre lies in the owner's screen box
    `aabb` (where given)}. With a scissor rect (the call's seventh
    argument, B1's scissor instantiation) every count but "old" takes the
    rect's pixels only: no other pixel is evaluated or written."""
    from bevy_tpu_torch.ops import raster3d_splat as splat
    from bevy_tpu_torch.ops.raster3d_visbuf import _scissor_vec
    depth, _, rows, owner, meta, wvalid = a[:6]
    sc = a[6] if len(a) > 6 else kw.get("scissor")
    sc = None if sc is None else _scissor_vec(sc, depth.device)
    win_h, ntri, nedge = kw["win_h"], kw["ntri"], kw["nedge"]
    H, W = depth.shape
    dev = depth.device
    stride = 3 * nedge + 4
    nv = int(wvalid.sum())
    flat_rows = rows.reshape(rows.shape[0], -1)
    lane = torch.arange(128, device=dev)
    row = torch.arange(win_h, device=dev)
    tile = (row[:, None] // 4) * 16 + lane[None, :] // 8
    keys = ("old", "kept", "inside", "writing", "dropped", "px", "in_box",
            "in_kept")
    n = dict.fromkeys(keys, 0)
    n["tiles"] = [0, 0]
    for c0 in range(0, nv, chunk):
        o = owner[c0:min(c0 + chunk, nv)].long()
        m = meta[c0:c0 + o.shape[0]]
        flat = flat_rows[o]
        kept = splat.window_px_kept(flat, m, depth, sc, win_h=win_h,
                                    ntri=ntri, nedge=nedge)
        rec = flat[:, :ntri * stride].reshape(-1, 1, 1, ntri, stride)
        x = ((m // 2048) * 128)[:, None, None] + lane[None, None, :]
        y = (m % 2048)[:, None, None] + row[None, :, None]
        px = x.float()[..., None] + 0.5
        py = y.float()[..., None] + 0.5
        frame = (x < W) & (y < H)
        n["old"] += int(frame.sum()) * ntri
        if sc is not None:          # a pixel outside the rect never writes
            frame = frame & (px[..., 0] >= sc[0]) & (px[..., 0] < sc[2]) & \
                (py[..., 0] >= sc[1]) & (py[..., 0] < sc[3])
        inside = frame[..., None]
        for j in range(nedge):
            e = (rec[..., 3 * j] * px + rec[..., 3 * j + 2]) + \
                rec[..., 3 * j + 1] * py
            inside = inside & (e <= 0)
        zb = 3 * nedge
        z = (rec[..., zb] * px + rec[..., zb + 2]) + rec[..., zb + 1] * py
        dep = depth[y.clamp(max=H - 1), x.clamp(max=W - 1)][..., None]
        writing = inside & (z > dep)
        kpx = kept[:, tile] & frame[..., None]
        t = torch.arange(kept.shape[1], device=dev)
        tx = ((m // 2048) * 128)[:, None] + (t % 16 * 8)[None, :]
        ty = (m % 2048)[:, None] + (t // 16 * 4)[None, :]
        n["kept"] += int(kpx.sum())
        n["inside"] += int((inside & kpx).sum())
        n["writing"] += int(writing.sum())
        n["dropped"] += int((writing & ~kpx).sum())
        n["tiles"][0] += int(kept.sum())
        n["tiles"][1] += int(((tx < W) & (ty < H)).sum()) * ntri
        n["px"] += int(frame.sum())
        n["in_kept"] += int((kpx.any(-1)).sum())
        if aabb is not None:
            bx = aabb[o][:, :, None, None]
            n["in_box"] += int((frame & (px[..., 0] >= bx[:, 0]) &
                                (px[..., 0] <= bx[:, 2]) &
                                (py[..., 0] >= bx[:, 1]) &
                                (py[..., 0] <= bx[:, 3])).sum())
    return n


def b1_cull_line(name, a, kw, aabb=None):
    """Log B1's cull counts for one call and assert that no dropped pair
    was inside its slot's edges."""
    n = work_b1(a, kw, aabb)
    box = "" if aabb is None else (
        f"; {n['in_box']} of them ({n['in_box'] / max(n['px'], 1):.2%}) in "
        f"the owner's screen box")
    log(f"B1 cull, {name} (win_h {kw['win_h']}, {kw['ntri']} slots of "
        f"{kw['nedge']} edges, {int(a[5].sum())} windows): (pixel, slot) "
        f"pairs the old walk reached {n['old']}, the tile cull keeps "
        f"{n['kept']} (replayed in plain torch by "
        f"raster3d_splat.window_px_kept), kept and inside the edges "
        f"{n['inside']}, inside with z above the depth (could write) "
        f"{n['writing']}, dropped that could write {n['dropped']}; "
        f"(tile, slot) pairs kept "
        f"{n['tiles'][0]} of {n['tiles'][1]}; window pixels in the frame "
        f"{n['px']}, in a kept tile {n['in_kept']} "
        f"({n['in_kept'] / max(n['px'], 1):.2%}){box}")
    if n["dropped"]:
        raise AssertionError(f"B1's cull dropped {n['dropped']} pairs that "
                             f"could write ({name})")
    return n


def bound_b1(a, kw):
    """B1: depth and winner read and written once; of each valid window's
    owner once, the ntri records the call reads (not the row's zero
    padding); owner, meta and wvalid of each valid window (9 B), and the
    wvalid byte past the valid prefix that ends the walk; the edge tests
    (2 mul, 2 add, 1 compare each) and the depth plane (2 mul, 2 add) with
    its compare of the (pixel, slot) pairs inside the slot's edges (what
    these inputs need: a pair outside writes nothing, nor does a zero
    padding slot over a depth >= 0). Returns (ms, bound by, text) with the
    old figure — whole padded record rows, 9 B of every window of the
    budget, every pixel of every valid window and every slot — and the
    pair counts in the text."""
    depth, _, rec_rows, owner, _, wvalid = a[:6]
    npx = depth.numel()
    nv = int(wvalid.sum())
    used = torch.unique(owner[wvalid.bool()]).numel()
    rec_b = kw["ntri"] * (3 * kw["nedge"] + 4) * 4
    nbytes = 16 * npx + used * rec_b + 9 * nv + min(1, owner.numel() - nv)
    old_bytes = 16 * npx + used * rec_rows.shape[1] * rec_rows.shape[2] * 4 \
        + 9 * owner.numel()
    per_pair = 5 * kw["nedge"] + 5
    n = work_b1(a, kw)             # main() logs this call's cull line
    ms, by = _bound(nbytes, n["inside"] * per_pair)
    old_ms, old_by = _bound(old_bytes, nv * kw["win_h"] * 128 * kw["ntri"]
                            * per_pair)
    mid_ms, mid_by = _bound(old_bytes, n["inside"] * per_pair)
    return ms, by, (f"recounted over {n['inside']} (pixel, slot) pairs "
                    f"inside the edges and {nbytes} B; the same pairs over "
                    f"whole rows and the whole budget ({old_bytes} B) "
                    f"{mid_ms:.4f} ms ({mid_by}); the old count, over every "
                    f"pixel of every window, {old_ms:.4f} ms ({old_by}); the "
                    f"tile cull keeps {n['kept']} of {n['old']} (plain "
                    f"replay)")


def work_b2(a, kw):
    """(pixel, triangle) pairs of one B2 call, over each tile's in-frame
    pixels: {"evaluated": the reference's (every pixel of the tile, for
    each listed triangle that passes its tile test), "kept": those in a
    block the kernel's cull keeps the triangle for
    (raster3d_visbuf.tri_in_stream_block's plain replay of it), "inside":
    evaluated pairs inside the edges (the walk's arithmetic), "dropped":
    inside but not kept (must be 0), "entries": (listed triangle, tile)
    entries passing the tile test, "blocks": (block, triangle) entries
    kept}."""
    from bevy_tpu_torch.ops import raster3d_visbuf as vis
    depth, _, recs, cl_table, cl_counts = a[:5]
    cs, th, tw = kw["cs"], kw["tile_h"], kw["tile_w"]
    H, W = depth.shape
    dev = depth.device
    keep = vis.tri_in_stream_block(recs, cl_table, cl_counts, H, W,
                                   tile_h=th, tile_w=tw, cs=cs)
    nt, nby, nbx, ns, _ = keep.shape
    ntx = (W + tw - 1) // tw
    ti = torch.arange(nt, device=dev)
    xi = torch.arange(tw, device=dev)[None, None, :] + \
        ((ti % ntx) * tw)[:, None, None]
    yi = torch.arange(th, device=dev)[None, :, None] + \
        ((ti // ntx) * th)[:, None, None]
    frame = ((xi < W) & (yi < H))[:, None]                # (nt, 1, th, tw)
    px, py = (xi.float() + 0.5)[:, None], (yi.float() + 0.5)[:, None]
    blk = (torch.arange(th, device=dev) // vis.STREAM_BLOCK_H)[:, None] * \
        nbx + (torch.arange(tw, device=dev) // vis.STREAM_BLOCK_W)[None, :]
    kflat = keep.reshape(nt, nby * nbx, ns, cs)
    ids = cl_table[:, :ns]
    listed = (torch.arange(ns, device=dev)[None, :] < cl_counts[:, None]) \
        & (ids >= 0)
    rec = recs[ids.clamp(min=0).long()][..., :cs * 20] \
        .reshape(nt, ns, cs, 20)
    tx0 = ((ti % ntx) * tw).float()[:, None, None]
    ty0 = ((ti // ntx) * th).float()[:, None, None]
    hit = listed[..., None] & (rec[..., 12] >= 0) & (rec[..., 15] > tx0) & \
        (rec[..., 13] < tx0 + tw) & (rec[..., 16] > ty0) & \
        (rec[..., 14] < ty0 + th)
    n = dict(evaluated=0, kept=0, inside=0, dropped=0,
             entries=int(hit.sum()), blocks=int(keep.sum()))
    npx = frame.sum((1, 2, 3))
    for sl in range(ns):
        d = rec[:, sl][:, :, None, None, :]               # (nt, cs, 1, 1, 20)
        inside = hit[:, sl][:, :, None, None] & frame
        for k in range(3):
            inside = inside & (d[..., 3 * k] * px + d[..., 3 * k + 1] * py +
                               d[..., 3 * k + 2] <= 0)
        kpx = kflat[:, blk, sl].permute(0, 3, 1, 2) & frame
        n["evaluated"] += int((hit[:, sl].sum(1) * npx).sum())
        n["kept"] += int(kpx.sum())
        n["inside"] += int(inside.sum())
        n["dropped"] += int((inside & ~kpx).sum())
    return n


def b2_cull_line(name, a, kw):
    """Log B2's cull counts (work_b2) for one call and assert that no
    dropped pair was inside the edges."""
    n = work_b2(a, kw)
    log(f"B2 cull, {name} ({kw['tile_h']}x{kw['tile_w']} tiles, "
        f"{int(a[4].sum())} listed clusters of {kw['cs']}): (pixel, "
        f"triangle) pairs the reference evaluates {n['evaluated']}, the "
        f"block cull keeps {n['kept']} (replayed in plain torch by "
        f"raster3d_visbuf.tri_in_stream_block) "
        f"({n['kept'] / max(n['evaluated'], 1):.2%}), inside the edges "
        f"{n['inside']}, dropped but inside {n['dropped']}; (tile, "
        f"triangle) entries past the tile test {n['entries']}, (block, "
        f"triangle) entries kept {n['blocks']}")
    if n["dropped"]:
        raise AssertionError(f"B2's cull dropped {n['dropped']} pairs "
                             f"inside the edges ({name})")
    return n


def bound_b2(a, kw):
    """B2: depth and winner read and written once, the listed clusters'
    record rows and table entries; per (tile, listed triangle) a 5-compare
    AABB test, and for each that passes, per tile pixel 3 edge planes and a
    depth plane (2 mul, 2 add each) and 4 compares."""
    depth, _, recs, cl_table, cl_counts = a[:5]
    cs, th, tw = kw["cs"], kw["tile_h"], kw["tile_w"]
    nt, max_cl = cl_table.shape
    live = (torch.arange(max_cl, device=depth.device)[None, :]
            < cl_counts[:, None]) & (cl_table >= 0)
    ids = cl_table.clamp(min=0).long()
    tri = recs[ids][..., :cs * 20].reshape(nt, max_cl, cs, 20)
    ntx = (depth.shape[1] + tw - 1) // tw
    t = torch.arange(nt, device=depth.device)
    tx0 = ((t % ntx) * tw).float()[:, None, None]
    ty0 = ((t // ntx) * th).float()[:, None, None]
    hit = live[..., None] & (tri[..., 12] >= 0) & (tri[..., 15] > tx0) & \
        (tri[..., 13] < tx0 + tw) & (tri[..., 16] > ty0) & \
        (tri[..., 14] < ty0 + th)
    nlisted = int(live.sum())
    nbytes = 16 * depth.numel() + 4 * (nlisted + nt) + \
        torch.unique(ids[live]).numel() * recs.shape[1] * 4
    flops = 5 * nlisted * cs + int(hit.sum()) * th * tw * 20
    return _bound(nbytes, flops)


def work_b3(a, kw):
    """(pixel, light) pairs of one B3 call, over its geometry pixels:
    {"old": the reference's walk (every listed light that passes the tile
    test), "kept": what the per-block cull keeps (shade.light_in_block's
    plain replay of it), "contrib": the pairs with win > 0 among the old
    walk, "dropped": those the cull drops (must be 0), "blocks": (block,
    light) pairs kept / listed}. The kernel evaluates a light body for kept pairs with win >
    0: "contrib" of them, since none is dropped."""
    from bevy_tpu_torch.ops import shade
    _, depth, table, counts, params, _ = a
    th, tw = kw.get("tile_h", 32), kw.get("tile_w", 128)
    rect = kw.get("rect", False)
    keep = shade.light_in_block(depth, table, counts, params, tile_h=th,
                                tile_w=tw, rect=rect)
    dep, wx, wy, wz = shade.tile_world_positions(depth, params, tile_h=th,
                                                 tile_w=tw)
    nt, nby, nbx, ns = keep.shape
    ntx = (depth.shape[1] + tw - 1) // tw
    B = shade.BLOCK
    geom = dep > 0
    gblk = geom.reshape(nt, nby, B, nbx, B).sum((2, 4))
    gtile = gblk.sum((1, 2))
    sp = shade.tile_side_planes(params, nt // ntx, ntx, th, tw)
    cnt = counts.clamp(max=table.shape[2])
    n = dict(old=0, kept=0, contrib=0, dropped=0)
    listed_blocks = 0
    for s_ in range(ns):
        rec = table[:, :, s_]
        walked = s_ < cnt
        if not rect:
            walked = walked & shade.light_in_tile(sp, rec, params)
        k = keep[..., s_]
        lit = (shade.light_win(rec, wx, wy, wz, rect) > 0) & geom & \
            walked[:, None, None]
        kpx = k.repeat_interleave(B, 1).repeat_interleave(B, 2)
        n["old"] += int((gtile * walked).sum())
        n["kept"] += int((gblk * k).sum())
        n["contrib"] += int(lit.sum())
        n["dropped"] += int((lit & ~kpx).sum())
        listed_blocks += int((s_ < cnt).sum()) * nby * nbx
    n["blocks"] = (int(keep.sum()), listed_blocks)
    return n


def b3_cull_line(name, a, kw):
    """Log B3's cull counts for one call and assert that no dropped pair
    would have contributed."""
    n = work_b3(a, kw)
    log(f"B3 cull, {name}: (pixel, light) pairs the old walk reached "
        f"{n['old']}, the block cull keeps {n['kept']} (replayed in plain "
        f"torch by shade.light_in_block), contributing "
        f"(win > 0) {n['contrib']}, dropped but contributing "
        f"{n['dropped']}; (block, light) pairs kept {n['blocks'][0]} of "
        f"{n['blocks'][1]} listed")
    if n["dropped"]:
        raise AssertionError(f"B3's cull dropped {n['dropped']} "
                             f"contributing pairs ({name})")
    return n


def bound_b3(a, kw):
    """B3: the planes its variant reads, depth, the shadow plane if any,
    the light records of every listed light, and 4 output planes, once
    each. Operations, FP32, counted from csrc/deferred_shade.cu (rsqrt,
    sqrt and division count 1; a common subexpression and a negation that
    folds into its user count 0):
    - per geometry pixel, the setup: world position, view vector,
      material terms, every term that depends on the pixel alone (a2 - 1,
      1 - alpha, nov * (1 - alpha) + alpha, 1 - f0), the directional
      light and the output: 158 (+26 clearcoat, +81 anisotropy, +2
      reflectance, +5 specular tint);
    - per listed (tile, light), the terms of the light alone (range²): 2
      (+1 rect);
    - per contributing (geometry pixel, listed light) pair (win > 0 —
      what these inputs need: a pair with win == 0 adds +0.0), the light
      body: 94 (+11 spot, +33 rect, +21 clearcoat, +33 anisotropy).
    Returns (ms, bound by, text) with the old figure — the body over every
    pair the reference's walk reaches (the tile test's survivors) — and
    the pair counts in the text."""
    gbuf, depth, table, counts, params, shadow = a
    v = {k: kw.get(k, d) for k, d in (("spot", True), ("rect", False),
                                      ("clearcoat", True),
                                      ("anisotropy", False),
                                      ("reflectance", False),
                                      ("specular_tint", False))}
    H, W = depth.shape
    nt, nf, mpt = table.shape
    planes = 12 + 2 * v["clearcoat"] + 4 * v["anisotropy"] + \
        v["reflectance"] + 3 * v["specular_tint"]
    cnt = counts.clamp(max=mpt)
    nbytes = 4 * H * W * (planes + 1 + (shadow is not None) + 4) + \
        4 * nf * int(cnt.sum()) + 4 * nt + 160
    body = 94 + 11 * v["spot"] + 33 * v["rect"] + 21 * v["clearcoat"] + \
        33 * v["anisotropy"]
    setup = 158 + 26 * v["clearcoat"] + 81 * v["anisotropy"] + \
        2 * v["reflectance"] + 5 * v["specular_tint"]
    per_light = 2 + v["rect"]
    n = b3_cull_line("full size", a, kw)
    base = int((depth > 0).sum()) * setup + int(cnt.sum()) * per_light
    ms, by = _bound(nbytes, n["contrib"] * body + base)
    old_ms, old_by = _bound(nbytes, n["old"] * body + base)
    return ms, by, (f"recounted over {n['contrib']} contributing (pixel, "
                    f"light) pairs; the old count, over the {n['old']} "
                    f"pairs the reference walks, {old_ms:.4f} ms "
                    f"({old_by}); the block cull keeps {n['kept']} "
                    f"(plain replay)")


# B4 / B5 operation counts, FP32, from csrc/sprite_tiles.cu and
# csrc/sprite_splat.cu (min, max, abs, floor, compare, select and a
# conversion count 1; a negation that folds into its user counts 0):
# - B4, per pixel: its centre (2) and the merge over the framebuffer (9);
#   per (pixel, sprite) the walk reaches: the coverage test (12); per
#   covered pair: the blend (16); per covered textured pair: the sample
#   (108; bf16 rounding +28).
# - B5, per pixel: its centre (2) and the merge (9); per (pixel, listed
#   window) the walk reaches: the row test (2); per pair in the window's
#   rows: the coverage (6; rotated 18); per covered pair: the blend (6
#   alpha_only, 9 otherwise); per covered textured pair: the sample (83
#   alpha_only, 110 otherwise; bf16 rounding +10 alpha_only, +28).
B4_OPS = dict(pixel=11, cover=12, blend=16, sample=108, sample_bf16=28)
B5_OPS = dict(pixel=11, row=2, cover=6, cover_rot=18, blend_alpha=6,
              blend=9, sample_alpha=83, sample=110, bf16_alpha=10,
              bf16=28)


def work_b4(a, kw):
    """(pixel, sprite) pairs of one B4 call: each in-frame pixel walks its
    tile's run front to back until its alpha is exactly 1.0, as the kernel
    does (the plain version's loop with counters). {"walked": the pairs
    the old walk (every listed sprite) reaches, "kept": walked pairs of
    sprites the kernel's per-block cull keeps (raster2d.sprite_in_block's
    plain replay of it), "covered": walked pairs inside the sprite,
    "textured": covered pairs of textured sprites, "dropped": listed pairs
    inside the sprite, whether or not the walk reaches them, that the cull
    drops (must be 0)}. A dropped sprite adds nothing to a pixel it does
    not cover, so the kernel's walk reaches the kept pairs."""
    from bevy_tpu_torch.ops import raster2d
    fb, pk, pair, starts, counts, atlas = a
    th, tw = kw.get("tile_h", 32), kw.get("tile_w", 128)
    _, H, W = fb.shape
    nty, ntx = (H + th - 1) // th, (W + tw - 1) // tw
    dev = fb.device
    ti = torch.arange(nty * ntx, device=dev)
    xi = torch.arange(tw, device=dev)[None, None, :] + \
        ((ti % ntx) * tw)[:, None, None]
    yi = torch.arange(th, device=dev)[None, :, None] + \
        ((ti // ntx) * th)[:, None, None]
    px, py = xi.float() + 0.5, yi.float() + 0.5
    bx, by = xi // raster2d.BLOCK * raster2d.BLOCK, \
        yi // raster2d.BLOCK * raster2d.BLOCK
    in_frame = (xi < W) & (yi < H)
    pa = torch.zeros(px.shape[0], th, tw, device=dev)
    n = dict.fromkeys(("walked", "kept", "covered", "textured", "dropped"),
                      0)
    for s_ in range(int(counts.max())):
        idx = torch.clamp(starts + counts - 1 - s_, 0, pair.shape[0] - 1)
        row = pk[pair[idx.long()].long()]
        d = [row[:, k][:, None, None] for k in range(17)]
        listed = (s_ < counts)[:, None, None] & in_frame
        live = listed & (pa < 1.0)
        dx, dy = px - d[0], py - d[1]
        inside = (torch.abs(d[4] * dx + d[5] * dy) <= d[2]) & \
            (torch.abs(-d[5] * dx + d[4] * dy) <= d[3])
        kept = raster2d.sprite_in_block(d, bx, by)
        ta = raster2d.sample_tiles(atlas, d, px, py, kw.get("bilinear", True),
                                   kw.get("bf16", False))[3]
        al = torch.where(inside & live, ta * d[9], 0.0)
        pa = pa + (1.0 - pa) * al
        cov = live & inside
        n["walked"] += int(live.sum())
        n["kept"] += int((live & kept).sum())
        n["covered"] += int(cov.sum())
        n["textured"] += int((cov & (d[14] >= 0)).sum())
        n["dropped"] += int((listed & inside & ~kept).sum())
    return n


def b4_cull_line(name, a, kw):
    """Log B4's cull counts for one call and assert that no dropped pair
    was covered."""
    n = work_b4(a, kw)
    log(f"B4 cull, {name}: (pixel, sprite) pairs the old walk reached "
        f"{n['walked']}, the block cull keeps {n['kept']} (replayed in "
        f"plain torch by raster2d.sprite_in_block), covered {n['covered']}, "
        f"dropped but covered {n['dropped']}")
    if n["dropped"]:
        raise AssertionError(f"B4's cull dropped {n['dropped']} covered "
                             f"pairs ({name})")
    return n


def bound_b4(a, kw):
    """B4: the framebuffer read and written once (32 B a pixel), each
    visible sprite row once (68 B), each listed pair index (4 B), the tile
    runs (8 B a tile) and the atlas; operations B4_OPS over the covered
    pairs the walk reaches (the coverage, blend and sample of a covered
    pair; what these inputs need). Returns (ms, bound by, text) with the
    old figure — the coverage test of every walked pair — and the pair
    counts."""
    fb, pk, pair, starts, counts, atlas = a
    n = b4_cull_line("full size", a, kw)
    npx = fb.shape[1] * fb.shape[2]
    nbytes = 32 * npx + 68 * pk.shape[0] + 4 * int(counts.sum()) + \
        8 * counts.numel() + 4 * atlas.numel()
    o = B4_OPS
    base = o["pixel"] * npx + o["blend"] * n["covered"] + \
        (o["sample"] + o["sample_bf16"] * kw.get("bf16", False)) * \
        n["textured"]
    ms, by = _bound(nbytes, base + o["cover"] * n["covered"])
    old_ms, old_by = _bound(nbytes, base + o["cover"] * n["walked"])
    return ms, by, (f"recounted over {n['covered']} covered (pixel, "
                    f"sprite) pairs; the old count, with the coverage test "
                    f"of the {n['walked']} walked pairs, {old_ms:.4f} ms "
                    f"({old_by}); the block cull keeps {n['kept']} (plain "
                    f"replay)")


def work_b5(a, kw):
    """(pixel, window) pairs of one B5 call: each in-frame pixel walks its
    8-row block's windows front to back until its alpha is exactly 1.0, as
    the kernel does. {"walked": the pairs the reference's walk reaches,
    "rows": those in the window's rows, "kept": walked pairs of windows
    the kernel's per-warp cull keeps (raster2d_splat.sprite_in_warp's plain
    replay of it), "covered": pairs inside the sprite, "textured": covered
    pairs of textured sprites, "dropped": covered pairs the cull drops
    (must be 0)}."""
    from bevy_tpu_torch.ops import raster2d_splat
    fb, pk, win, blk_win, blk_start, blk_count, atlas = a
    win_h = kw.get("win_h", 40)
    rotated = kw.get("rotated", True)
    _, H, W = fb.shape
    ncols = (W + 127) // 128
    nb = blk_start.shape[0]
    nrb = nb // ncols
    dev = fb.device
    bi = torch.arange(nb, device=dev)
    xi = torch.arange(128, device=dev)[None, None, :] + \
        ((bi // nrb) * 128)[:, None, None]
    yi = torch.arange(8, device=dev)[None, :, None] + \
        ((bi % nrb) * 8)[:, None, None]
    px, py = xi.float() + 0.5, yi.float() + 0.5
    x0 = xi // raster2d_splat.WARP_W * raster2d_splat.WARP_W
    in_frame = (xi < W) & (yi < H)
    pa = torch.zeros(nb, 8, 128, device=dev)
    n = dict.fromkeys(("walked", "rows", "kept", "covered", "textured",
                       "dropped"), 0)
    for s_ in range(int(blk_count.max())):
        w = blk_win[torch.clamp(blk_start + s_, 0,
                                blk_win.shape[0] - 1).long()].long()
        wrec = win[w]
        row = pk[torch.clamp(wrec[:, 0], min=0).long()]
        d = [row[:, k][:, None, None] for k in range(17)]
        wy0 = wrec[:, 2][:, None, None]
        live = (s_ < blk_count)[:, None, None] & (pa < 1.0) & in_frame
        rows = live & (yi >= wy0) & (yi < wy0 + win_h)
        if rotated:
            cs, sn = d[4], d[5]
            lx = cs * px - (cs * d[0] + sn * d[1]) + sn * py
            ly = -sn * px + (sn * d[0] - cs * d[1]) + cs * py
        else:
            lx, ly = px - d[0], py - d[1]
        inside = (torch.abs(lx) <= d[2]) & (torch.abs(ly) <= d[3])
        cov = rows & inside
        kept = raster2d_splat.sprite_in_warp(d, wy0, x0, yi, win_h=win_h,
                                             rotated=rotated)
        # alpha reaches 1 only through the texel alpha times the tint;
        # sample it as the kernel does (lx/ly on the window's edges when
        # rotated)
        if rotated:
            px0 = (wrec[:, 1] * 128).float()[:, None, None] + 0.5
            lxs = cs * px - (cs * d[0] + sn * d[1]) + sn * (wy0.float() + 0.5)
            lys = -sn * px0 + (sn * d[0] - cs * d[1]) + cs * py
        else:
            lxs, lys = lx, ly
        ta = raster2d_splat.sample_splat(
            atlas, d, lxs, lys, kw.get("bilinear", True),
            kw.get("bf16", False), kw.get("alpha_only", False))[3]
        pa = pa + (1.0 - pa) * torch.where(cov, ta * d[9], 0.0)
        n["walked"] += int(live.sum())
        n["rows"] += int(rows.sum())
        n["kept"] += int((live & kept).sum())
        n["covered"] += int(cov.sum())
        n["textured"] += int((cov & (d[14] >= 0)).sum())
        n["dropped"] += int((cov & ~kept).sum())
    return n


def b5_cull_line(name, a, kw):
    """Log B5's cull counts for one call and assert that no dropped pair
    was covered."""
    n = work_b5(a, kw)
    log(f"B5 cull, {name}: (pixel, window) pairs the old walk reached "
        f"{n['walked']}, the warp cull keeps {n['kept']} (replayed in plain "
        f"torch by raster2d_splat.sprite_in_warp), covered {n['covered']}, "
        f"dropped but covered {n['dropped']}")
    if n["dropped"]:
        raise AssertionError(f"B5's cull dropped {n['dropped']} covered "
                             f"pairs ({name})")
    return n


def bound_b5(a, kw):
    """B5: the framebuffer read and written once (32 B a pixel), each
    visible sprite row once (68 B), each window record (12 B), each block
    list entry (4 B), the block runs (8 B a block) and the atlas planes it
    samples; operations B5_OPS over the pairs inside each sprite's extent
    that the walk reaches (the coverage, blend and sample of a covered
    pair; what these inputs need). Returns (ms, bound by, text) with the
    old figure — also the row test of every walked pair and the coverage
    of every pair in the window's rows — and the pair counts."""
    fb, pk, win, blk_win, blk_start, blk_count, atlas = a
    alpha = kw.get("alpha_only", False)
    bf16 = kw.get("bf16", False)
    n = b5_cull_line("full size", a, kw)
    npx = fb.shape[1] * fb.shape[2]
    nwin = int((win[:, 0] >= 0).sum())
    nbytes = 32 * npx + 68 * pk.shape[0] + 12 * nwin + \
        4 * int(blk_count.sum()) + 8 * blk_count.numel() + \
        4 * atlas[0].numel() * (1 if alpha else 4)
    o = B5_OPS
    sample = (o["sample_alpha"] + o["bf16_alpha"] * bf16) if alpha else \
        (o["sample"] + o["bf16"] * bf16)
    cover = o["cover_rot"] if kw.get("rotated", True) else o["cover"]
    blend = o["blend_alpha"] if alpha else o["blend"]
    base = o["pixel"] * npx + blend * n["covered"] + sample * n["textured"]
    ms, by = _bound(nbytes, base + cover * n["covered"])
    old_ms, old_by = _bound(nbytes, base + o["row"] * n["walked"] +
                            cover * n["rows"])
    return ms, by, (f"recounted over {n['covered']} covered (pixel, "
                    f"window) pairs; the old count, with the row test of "
                    f"the {n['walked']} walked pairs and the coverage of "
                    f"{n['rows']} in the window's rows, {old_ms:.4f} ms "
                    f"({old_by}); the warp cull keeps {n['kept']} (plain "
                    f"replay)")


def _b6_pixels(a, kw):
    """The frame index (nv, win_h, 128) of every pixel of the valid
    windows of one B6 call, and which of them lie in the frame."""
    depth, _, windows, owner, meta, wvalid = a
    H, W = depth.shape
    dev = depth.device
    m = meta[wvalid]
    x = ((m // 2048) * 128)[:, None, None] + \
        torch.arange(128, device=dev)[None, None, :]
    y = (m % 2048)[:, None, None] + \
        torch.arange(kw["win_h"], device=dev)[None, :, None]
    return (y.clamp(max=H - 1) * W + x.clamp(max=W - 1)).long(), \
        (x < W) & (y < H)


def b6_work_line(name, a, kw):
    """Log B6's pixel counts for one call: the valid windows' in-frame
    pixels (each read once), those not empty (dz != 0), those the kernel
    loads a depth for (all of them where some incoming depth is below 0,
    else those with dz > 0) and those that beat the incoming depth (each an
    atomic)."""
    depth, _, windows, owner, meta, wvalid = a
    p, inb = _b6_pixels(a, kw)
    dz = windows[wvalid]
    neg = bool((depth < 0).any())
    log(f"B6 work, {name} ({int(wvalid.sum())} valid windows of "
        f"{wvalid.shape[0]}, win_h {kw['win_h']}, a depth below 0: {neg}): "
        f"window pixels read {int(inb.sum())}, not empty "
        f"{int((inb & (dz != 0)).sum())}, depth loads "
        f"{int((inb & ((dz > 0) | neg)).sum())}, beating the depth "
        f"{int((inb & (dz > depth.reshape(-1)[p])).sum())}")


def bound_b6(a, kw):
    """B6: each valid window's in-frame pixels read once (4 B), each
    window's valid flag (1 B) and each valid window's meta and owner (8 B),
    and the depth and winner of every pixel a window touches read and
    written once (16 B); one compare per window pixel read."""
    depth, _, windows, owner, meta, wvalid = a
    p, inb = _b6_pixels(a, kw)
    npx = int(inb.sum())
    touched = torch.zeros(depth.numel(), dtype=torch.bool,
                          device=depth.device)
    touched[p[inb]] = True
    nbytes = 4 * npx + owner.numel() + 8 * int(wvalid.sum()) + \
        16 * int(touched.sum())
    return _bound(nbytes, npx) + (f"{npx} window pixels, "
                                  f"{int(touched.sum())} touched",)


def library_b6(a, kw):
    """One `scatter_reduce_(amax)` over the int64 keys of B6's merge (the
    plain version's keys, every valid window at once): the one PyTorch
    call that computes the merge, before the decode."""
    from bevy_tpu_torch.ops import raster3d_splat as sp
    depth, _, windows, owner, meta, wvalid = a
    p, inb = _b6_pixels(a, kw)
    dz = windows[wvalid]
    d0 = depth.reshape(-1)
    take = inb & (dz > d0[p])
    w = torch.nonzero(wvalid)[:, 0]
    keys = (sp.order_key(dz) * sp._HI |
            (0xFFFFFFFE - w)[:, None, None]).reshape(-1)
    idx = torch.where(take, p, depth.numel()).reshape(-1)
    key = torch.cat([sp.order_key(d0) * sp._HI | sp._LOW,
                     torch.zeros(1, dtype=torch.int64, device=depth.device)])
    return lambda: key.scatter_reduce_(0, idx, keys, "amax")


# B7 / B8 operation counts, FP32, of the function (compare, select, clamp,
# rsqrt and division count 1; a negation that folds into its user counts
# 0):
# - per pixel: its centre (2) and, with the scissor, its test (4);
# - per (tile, listed triangle), corners only: the three edge vectors
#   (cx-bx, cy-by, ...: 6 sub), once a triangle as the reference computes
#   them (csrc/tri_raster.cu stages them once a record);
# - per (pixel, triangle) pair tested: the edge tests (corners: 3 x (2 sub,
#   2 mul, 1 sub) + 3 compares = 18; planes: 3 x (2 mul, 2 add, compare)
#   = 15);
# - per such pair inside the edges: the depth (corners: 3 mul for the
#   barycentrics + 3 mul, 2 add + compare = 9; planes: 2 mul, 2 add +
#   compare = 5);
# - per covered pixel (one that some triangle took), once: the winner's
#   shade (corners 50, planes 46: 1/w and its clamp, three normals and
#   their divisions, the length and its rsqrt, Lambert, three colour
#   channels; planes_gbuf 30: the normal and its normalisation). The
#   kernel shades every pair that passes the depth test, the plain version
#   only the winner: the same bits.
# The bound charges what these inputs need: the edge tests and the depth
# over the pairs inside the edges, the edges once a listed triangle and the
# shade once a covered pixel. The reference's walk tests every listed pair
# (the old count; work_tris counts both, and what B7's cull keeps).
TRI_OPS = dict(pixel=2, scissor=4, edges_corners=6, edges_planes=0,
               walk_corners=18, walk_planes=15, inside_corners=9,
               inside_planes=5, shade_corners=50, shade_planes=46,
               shade_planes_gbuf=30)


def work_tris(a, kw):
    """Counts of one B7/B8 call, as a dict: (pixel, triangle) pairs
    "walked" by the reference (every listed pair), "inside" the edges,
    "passing" the depth test; "covered" pixels (some triangle took them);
    "live" pixels; distinct triangles "tris_listed" (in some tile's list),
    "tris_inside" (inside the edges at some live pixel) and "tris_won" (the
    last taker of some pixel). Each in-frame pixel (inside the scissor,
    when one is given) walks its tile's list in order, as the plain
    version does. Also the kernel's cull, replayed in plain torch at the
    warps' WARP_ROWS granularity (raster3d_tris.tri_in_block for B7,
    plane_in_block for B8; a warp's test implies the CTA's block test):
    "kept", the pairs the kernel walks, and "dropped", the pairs it drops
    that are inside the edges (must be 0)."""
    from bevy_tpu_torch.ops import raster3d_tris as rt
    fb, depth, table, pair_tri, starts, counts, light = a[:7]
    scissor = a[7] if len(a) > 7 else kw.get("scissor")
    layout = kw.get("layout", "corners")
    th, tw = kw.get("tile_h", 32), kw.get("tile_w", 128)
    H, W = depth.shape
    nty, ntx = (H + th - 1) // th, (W + tw - 1) // tw
    dev = depth.device
    ti = torch.arange(nty * ntx, device=dev)
    xi = torch.arange(tw, device=dev)[None, None, :] + \
        ((ti % ntx) * tw)[:, None, None]
    yi = torch.arange(th, device=dev)[None, :, None] + \
        ((ti // ntx) * th)[:, None, None]
    px, py = xi.float() + 0.5, yi.float() + 0.5
    live = (xi < W) & (yi < H)
    if scissor is not None:
        x0, y0, x1, y1 = (float(v) for v in scissor)
        live = live & (px >= x0) & (py >= y0) & (px < x1) & (py < y1)
    dep = torch.nn.functional.pad(depth, (0, ntx * tw - W, 0, nty * th - H)) \
        .reshape(nty, th, ntx, tw).permute(0, 2, 1, 3).reshape(-1, th, tw)
    replay = rt.tri_in_block if layout == "corners" else rt.plane_in_block
    keep = replay(table, pair_tri, starts, counts, W, tile_h=th, tile_w=tw,
                  block_h=rt.WARP_ROWS)
    n = dict(walked=0, inside=0, passing=0, kept=0, dropped=0)
    won = torch.full(live.shape, -1, dtype=torch.int64, device=dev)
    listed = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    inside_tris = torch.zeros_like(listed)
    for s_ in range(int(counts.max())):
        on = live & (s_ < counts)[:, None, None]
        slot = torch.clamp(starts + s_, max=pair_tri.shape[0] - 1).long()
        tri = pair_tri[slot].long()
        d = table[tri][:, :, None, None].unbind(1)
        if layout == "corners":
            e = [(d[4] - d[2]) * (py - d[3]) - (d[5] - d[3]) * (px - d[2]),
                 (d[0] - d[4]) * (py - d[5]) - (d[1] - d[5]) * (px - d[4]),
                 (d[2] - d[0]) * (py - d[1]) - (d[3] - d[1]) * (px - d[0])]
            inside = (e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0)
            z = e[0] * d[12] * d[6] + e[1] * d[12] * d[7] + \
                e[2] * d[12] * d[8]
        else:
            inside = (d[0] * px + d[1] * py + d[2] <= 0) & \
                (d[3] * px + d[4] * py + d[5] <= 0) & \
                (d[6] * px + d[7] * py + d[8] <= 0)
            z = d[9] * px + d[10] * py + d[11]
        hit = on & inside
        passing = hit & (z > dep)
        dep = torch.where(passing, z, dep)
        won = torch.where(passing, tri[:, None, None], won)
        listed[tri[s_ < counts]] = True
        inside_tris[tri[hit.any(2).any(1)]] = True
        n["walked"] += int(on.sum())
        n["inside"] += int(hit.sum())
        n["passing"] += int(passing.sum())
        kpx = keep[..., s_].repeat_interleave(rt.WARP_ROWS, 1) \
            .repeat_interleave(rt.BLOCK, 2)
        n["kept"] += int((on & kpx).sum())
        n["dropped"] += int((hit & ~kpx).sum())
    n["covered"] = int((won >= 0).sum())
    n["live"] = int(live.sum())
    n["tris_listed"] = int(listed.sum())
    n["tris_inside"] = int(inside_tris.sum())
    n["tris_won"] = int(torch.unique(won[won >= 0]).numel())
    return n


def tri_cull_line(kid, name, n):
    """Log B7's or B8's cull counts (work_tris) for one call and assert
    that no dropped pair was inside the edges."""
    replay = "tri_in_block" if kid == "B7" else "plane_in_block"
    log(f"{kid} cull, {name}: (pixel, triangle) pairs the old walk reached "
        f"{n['walked']}, the cull keeps {n['kept']} (replayed in plain "
        f"torch by raster3d_tris.{replay}) "
        f"({n['kept'] / max(n['walked'], 1):.2%}), inside the edges "
        f"{n['inside']}, dropped but inside {n['dropped']}")
    if n["dropped"]:
        raise AssertionError(f"{kid}'s cull dropped {n['dropped']} pairs "
                             f"inside the edges ({name})")


# The record fields the function needs of a triangle, by what it does
# (floats; the rest of the 40-float row is padding): the edges of every
# listed one (corners 0:6; planes 0:9), the depth of one inside the edges
# at some pixel (corners 6:9 and 1/area2 at 12; planes 9:12), and the
# shade of one that wins a pixel (corners 9:12 and 13:29; planes 12:31,
# planes_gbuf 12:33).
TRI_FIELDS = dict(corners=(6, 4, 19), planes=(9, 3, 19),
                  planes_gbuf=(9, 3, 21))


def bound_tris(a, kw):
    """B7 / B8: the framebuffer (or every G-buffer plane) and depth read
    and written once, each listed pair index, the tile runs, the light
    vector and the record fields TRI_FIELDS by what each triangle does
    (work_tris: listed, inside at some pixel, winning some pixel);
    operations TRI_OPS over the listed (tile, triangle) pairs and
    work_tris's counts: the edge tests and the depth over the pairs inside
    the edges. Returns (ms, bound by, text) with the old figures (the
    edge tests over every listed pair; 29 or 33 floats a listed record)
    and the counts in the text."""
    fb, depth, table, pair_tri, starts, counts = a[:6]
    layout = kw.get("layout", "corners")
    scissor = a[7] if len(a) > 7 else kw.get("scissor")
    n = work_tris(a, kw)
    tri_cull_line(kernel_id(kernel_fn("B7"), kw), f"full size ({layout})", n)
    f_edge, f_depth, f_shade = TRI_FIELDS[layout]
    other = 8 * (fb.numel() + depth.numel()) + 4 * int(counts.sum()) + \
        8 * counts.numel() + 64
    nbytes = other + 4 * (f_edge * n["tris_listed"] +
                          f_depth * n["tris_inside"] +
                          f_shade * n["tris_won"])
    old_bytes = other + 4 * (29 if layout == "corners" else 33) * \
        n["tris_listed"]
    kind = "corners" if layout == "corners" else "planes"
    o = TRI_OPS
    base = (o["pixel"] + o["scissor"] * (scissor is not None)) * n["live"] \
        + o["edges_" + kind] * int(counts.sum()) + \
        o["inside_" + kind] * n["inside"] + o["shade_" + layout] * n["covered"]
    ms, by = _bound(nbytes, base + o["walk_" + kind] * n["inside"])
    old_ms, old_by = _bound(old_bytes, base + o["walk_" + kind] * n["walked"])
    mid_ms, mid_by = _bound(old_bytes, base + o["walk_" + kind] * n["inside"])
    return ms, by, (f"the old count, every walked pair and whole records, "
                    f"{old_ms:.4f} ms ({old_by}); operations recounted but "
                    f"whole records {mid_ms:.4f} ms ({mid_by}); bytes "
                    f"{nbytes} (whole records {old_bytes}); triangles "
                    f"listed {n['tris_listed']}, inside at a pixel "
                    f"{n['tris_inside']}, winning a pixel {n['tris_won']}; "
                    f"{n['walked']} (pixel, triangle) pairs walked by the "
                    f"reference, {n['inside']} inside ("
                    f"{n['inside'] / max(n['walked'], 1):.2%}), "
                    f"{n['passing']} passing, {n['covered']} pixels "
                    f"covered")


BOUNDS = {"B1": bound_b1, "B2": bound_b2, "B3": bound_b3, "B4": bound_b4,
          "B5": bound_b5, "B6": bound_b6, "B7": bound_tris, "B8": bound_tris}


def near_plane_app(device):
    """Cubes around and just in front of a camera at the origin: giant
    footprints and near-plane straddlers, which the window path hands to
    the streaming-tile kernel."""
    from bevy_tpu_torch import App
    from bevy_tpu_torch.render import RenderPlugin
    from bevy_tpu_torch.render.camera import Camera3d
    from bevy_tpu_torch.render.mesh import cuboid
    from bevy_tpu_torch.render.mesh3d import (
        DirectionalLight, Mesh3d, Mesh3dPlugin, MeshMaterial)
    from bevy_tpu_torch.time import TimePlugin
    from bevy_tpu_torch.transform import (
        GlobalTransform, Transform, TransformPlugin, transform_bundle)

    app = App(capacity=64, device=device)
    plugin = Mesh3dPlugin(tile_h=16, window_budget=4096, eval_tris=8)
    cube = plugin.add_mesh(cuboid())
    # 640x360: a full-viewport footprint spans 5 x 12 window blocks, over
    # build_windows' 32-block cap, so straddlers go to the fallback
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=640, height=360), plugin)
    app.world.spawn(Camera3d(), *transform_bundle())
    app.world.spawn(DirectionalLight(),
                    *transform_bundle(rotation=(-0.3826834, 0.0, 0.0,
                                                0.9238795)))
    rng = np.random.RandomState(3)
    n = 24
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(-6.0, 0.4, n)], 1).astype(np.float32)
    col = np.concatenate([rng.uniform(0.2, 1.0, (n, 3)),
                          np.ones((n, 1))], 1).astype(np.float32)
    app.world.spawn_batch([Mesh3d(mesh=cube), MeshMaterial(base_color=col),
                           Transform(translation=xyz),
                           GlobalTransform(translation=xyz)], n)
    return app


def check_golden(img, path):
    img = img.astype(int)
    golden = read_png_rgba8(path)
    if img.shape != golden.shape:
        raise AssertionError(f"golden shape {golden.shape} != {img.shape}")
    diff = np.abs(golden - img).max(-1)
    frac = float((diff > 8).mean())
    log(f"golden {path.stem}: {frac:.4%} of pixels drift > 8 "
        f"(max channel diff {diff.max()})")
    if frac >= 0.01:
        raise AssertionError(f"golden {path.stem} failed")


def check_stats(state, keys):
    stats = {k: int(v) for k, v in state["res"]["render_stats"].items()}
    bad = {k: stats[k] for k in keys if stats[k] != 0}
    if bad:
        raise AssertionError(f"overflow counters not 0: {bad}")


def timed_frames(app, n):
    """3 warm frames, then `n` frames timed with CUDA events, with the
    launch counts set to 0 just before and read just after. Returns
    ms/frame, launches, render_stats over the n frames and the
    covered-pixel share; raises unless colour and depth are finite."""
    step = app.frame_fn()
    state = app.world.state
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    stats0 = {k: int(v) for k, v in state["res"]["render_stats"].items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_launches()
    start.record()
    for _ in range(n):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    app.world.state = state
    stats = {k: int(v) - stats0[k]
             for k, v in state["res"]["render_stats"].items()}
    color = state["res"]["render_target"]["color"]
    depth = state["res"]["render_target"]["depth"]
    if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
        raise AssertionError("full-size frame is not finite")
    covered = float((depth > 0).float().mean())
    return start.elapsed_time(end) / n, launches, stats, covered


def device_ms(fn, reps=20):
    """(ms a call on the device, [(kernel name, ms a call), ...] largest
    first, from torch.profiler where it kept any record; [] where not).

    The time: `reps` calls queued behind a spin kernel that outlasts
    their enqueue, between two CUDA events, so the calls run back to back
    and the host's time between launches is left out (the kernels' time
    plus the device's gaps between launches, a microsecond or two each).
    Raises if the enqueue outlasted the spin (the queue ran dry).

    torch.profiler is not the measure: in long runs it kept fewer kernel
    records than calls, or none (B5 at full size, twice), so a sum over
    its records read low or nothing. The split by kernel is each kernel's
    mean over the records kept times its launches a call (records / reps,
    rounded, at least 1)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spun.record()
    torch.cuda._sleep(int(max(2e6, 8 * reps * host_s * 2e9)))  # ~2 GHz
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if enqueue_ms >= spun.elapsed_time(start):
        raise AssertionError(f"device_ms: the enqueue ({enqueue_ms:.3f} ms) "
                             f"outlasted the spin kernel")
    ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / e.count
             * max(1, round(e.count / reps)) / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return ms, sorted(rows, key=lambda r: -r[1])


def time_kernel(kid, a, kw, launches, err, library=None,
                where="at full size"):
    """Kernel vs plain time (CUDA events, 20 and 3 launches), the time of
    `library` (one PyTorch call computing the same function, 20 calls)
    where there is one, and the bound at one recorded call (`where` names
    it in the log); the kernels-line entry."""
    k_ms = cuda_ms(lambda: kernel_fn(kid)(*a, **kw), 20)
    p_ms = cuda_ms(lambda: plain_fn(kid)(*a, **kw), 3)
    lib_ms = None if library is None else cuda_ms(library, 20)
    b = BOUNDS[kid](a, kw)
    b_ms, by = b[0], b[1]
    extra = "" if len(b) < 3 else f"; {b[2]}"
    lib = "" if lib_ms is None else f", library call {lib_ms:.4f} ms"
    was = f" (before the redesign: {BEFORE_REDESIGN_MS[kid]} ms)" \
        if kid in BEFORE_REDESIGN_MS else ""
    log(f"{kid} {KERNELS[kid][0]} {where}: kernel {k_ms:.4f} ms{was}, "
        f"plain {p_ms:.4f} ms{lib}, bound {b_ms:.4f} ms ({by}{extra}), "
        f"{b_ms / k_ms:.1%} of the bound")
    d_ms, rows = device_ms(lambda: kernel_fn(kid)(*a, **kw))
    log(f"{kid} device time a call {where} (20 calls queued behind a spin "
        f"kernel, "
        f"CUDA events): {d_ms:.4f} ms; by kernel (torch.profiler): "
        + ("; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in rows[:3])
           or "no record kept"))
    name, source, replaces = KERNELS[kid]
    if kid in ("B7", "B8"):          # one wrapper, two kernels
        name = f"{name}(layout={kw['layout']})"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def variants_app(device):
    """The lights golden scene plus spot lights, rect lights and a
    clearcoat cube with a non-default reflectance: the B3 instantiation
    with spot, rect, clearcoat and reflectance on (24-field records)."""
    import torch_many_lights
    from bevy_tpu_torch.render.deferred import RectLight, SpotLight
    from bevy_tpu_torch.render.mesh3d import Mesh3d, MeshMaterial
    from bevy_tpu_torch.transform import transform_bundle

    app = torch_many_lights.build_app(device=device, n_lights=24, n_cubes=9,
                                      width=256, height=144, capacity=128,
                                      camera=(0.0, 9.0, 22.0))
    down = (-0.7071068, 0.0, 0.0, 0.7071068)      # -Z turned to -Y
    for i, x in enumerate((-6.0, 0.0, 6.0)):
        app.world.spawn(SpotLight(color=(1.0, 0.6, 0.3), intensity=6.0,
                                  range=12.0, inner_angle=0.2 + 0.1 * i,
                                  outer_angle=0.6),
                        *transform_bundle(translation=(x, 4.0, 2.0),
                                          rotation=down))
        app.world.spawn(RectLight(color=(0.3, 0.7, 1.0), intensity=4.0,
                                  range=10.0, width=2.0, height=1.0 + i),
                        *transform_bundle(translation=(x, 3.0, -4.0),
                                          rotation=down))
    app.world.spawn(Mesh3d(mesh=0),
                    MeshMaterial(base_color=(0.9, 0.2, 0.2, 1.0),
                                 clearcoat=1.0, clearcoat_roughness=0.2,
                                 reflectance=0.8, perceptual_roughness=0.3),
                    *transform_bundle(translation=(0.0, 1.0, 6.0),
                                      scale=(2.0, 2.0, 2.0)))
    return app


def b4_scenes(device):
    """B4 against plain, bit for bit, with its cull counts, on the CPU
    test scenes."""
    from torch_scenes import sprite_scene
    from bevy_tpu_torch.ops import raster2d
    cases = [("f32 bilinear", dict(seed=0), {}, {}),
             ("f32 nearest", dict(seed=0), {}, dict(bilinear=False)),
             ("bf16", dict(seed=0), {}, dict(bf16=True)),
             ("rotated solid", dict(seed=1, rot=True), {}, {}),
             ("max_visible 40 of 120", dict(seed=2, n=120),
              dict(max_visible=40), {}),
             ("overflowing tile", dict(seed=3, n=300, big=True),
              dict(max_per_tile=100), {})]
    for name, sc, bin_kw, kw in cases:
        fb, p, atlas = sprite_scene(device=device, **sc)
        pk, pair, starts, counts, st = raster2d.bin_sprites(
            p, fb.shape[1], fb.shape[2], **bin_kw)
        a = (fb, pk, pair, starts, counts, atlas)
        err = compare("B4", a, kw)
        log(f"B4 vs plain, {name}: bit-equal (max abs err {err}; "
            f"{int(counts.sum())} listed, tile_overflow "
            f"{int(st['tile_overflow'])}, visible_overflow "
            f"{int(st['visible_overflow'])})")
        b4_cull_line(name, a, kw)


def b5_scenes(device):
    """B5 against plain, bit for bit, with its cull counts: all 16
    variants, sprites straddling the warps' 32-column boundaries, and
    tall, equal-z and opaque-wall scenes on bevymark's variant."""
    from bevy_tpu_torch.ops import raster2d_splat
    from torch_scenes import b5_straddle_scene, sprite_scene

    def run(name, fb, p, atlas, **kw):
        pk, win, bw, bs, bc, st = raster2d_splat.build_sprite_windows(
            p, fb.shape[1], fb.shape[2], windows_per_sprite=8)
        if int(st["pair_overflow"]):
            raise AssertionError(f"B5 scene {name} overflowed its windows")
        a = (fb, pk, win, bw, bs, bc, atlas)
        err = compare("B5", a, kw)
        log(f"B5 vs plain, {name}: bit-equal (max abs err {err}; "
            f"{int((win[:, 0] >= 0).sum())} windows)")
        b5_cull_line(name, a, kw)

    for rot in (False, True):
        for alpha in (False, True):
            for bf16 in (False, True):
                for bil in (True, False):
                    fb, p, atlas = sprite_scene(4, device, n=24, H=72, W=160,
                                                atlas_hw=8, rot=rot)
                    if alpha:
                        atlas[:3] = 1.0
                    run(f"rotated={rot} alpha_only={alpha} bf16={bf16} "
                        f"bilinear={bil}", fb, p, atlas, rotated=rot,
                        alpha_only=alpha, bf16=bf16, bilinear=bil)
        fb, p, atlas = b5_straddle_scene(10, device, rot)
        run(f"straddling 32-column boundaries, rotated={rot}", fb, p, atlas,
            rotated=rot)
    bev = dict(rotated=False, alpha_only=True, bf16=True)
    fb, p, atlas = sprite_scene(5, device, n=24, H=72, W=160, atlas_hw=8,
                                big=True)
    atlas[:3] = 1.0
    p[:, 3] *= 2.0
    run("tall (aligned bands)", fb, p, atlas, **bev)
    fb, p, atlas = sprite_scene(6, device, n=24, H=72, W=160, atlas_hw=8,
                                ties=True)
    atlas[:3] = 1.0
    p[:, 0:2] = 60 + torch.tensor(np.random.RandomState(6).uniform(
        -10, 10, (24, 2)), dtype=torch.float32, device=device)
    p[:, 16] = 1.0
    run("equal z", fb, p, atlas, **bev)
    fb, p, atlas = sprite_scene(7, device, n=24, H=72, W=160, atlas_hw=8)
    atlas[:3] = 1.0
    p[:, 0], p[:, 1], p[:, 2:4] = 80.0, 36.0, 30.0
    p[:, 15] = torch.linspace(1, 0, 24, device=device)
    p[:, 16] = 1.0
    p[23, 9], p[23, 14] = 1.0, -1.0
    run("opaque wall", fb, p, atlas, **bev)


def frame_drawn(state):
    """Share of pixels whose colour differs from the clear colour."""
    color = state["res"]["render_target"]["color"]
    clear = state["res"]["clear_color"]["color"][:, None, None]
    if not torch.isfinite(color).all():
        raise AssertionError("sprite frame is not finite")
    return float((color != clear).any(0).float().mean())


def sprite_phases(dev, n, smi, results):
    """Phases 9-14: B4 and B5 against plain on the test scenes, the
    breakout golden, many_sprites 100k and bevymark at full size, and B4 /
    B5 timed beside their bounds (entries of `results`)."""
    import torch_bevymark
    import torch_breakout
    import torch_many_sprites
    from bevy_tpu_torch.render import frame_image

    # -- B4: CPU test scenes on the card ---------------------------------
    b4_scenes(dev)

    # -- breakout golden: B4 vs plain on every call + image --------------
    bapp = torch_breakout.build_app(device=dev, **BREAKOUT_GOLDEN_KW)
    with Recorder() as rec_b:
        bapp.run(max_frames=25, dt=1 / 60)
    torch.cuda.synchronize()
    errs = [compare("B4", a, kw) for a, kw in rec_b.calls["B4"]]
    if len(errs) != 25:
        raise AssertionError(f"breakout called B4 {len(errs)} times in 25 "
                             f"frames")
    log(f"B4 vs plain, breakout golden: {len(errs)} calls bit-equal (max "
        f"abs err {max(errs)})")
    check_golden(frame_image(bapp), BREAKOUT_GOLDEN)
    check_stats(bapp.world.state, ("pair_overflow", "tile_overflow",
                                   "visible_overflow"))
    log(f"breakout score after 25 frames: "
        f"{int(bapp.world.state['res']['score']['value'])}")
    del bapp, rec_b

    # -- many_sprites at full size: 100k sprites, 1280x720 ----------------
    app = torch_many_sprites.build_app(device=dev)
    ms, launches, stats, _ = timed_frames(app, n)
    drawn = frame_drawn(app.world.state)
    log(f"many_sprites 100000 @1280x720: {ms:.3f} ms/frame over {n} frames "
        f"(CUDA events; {smi})")
    log(f"launches in those {n} frames: B4 {launches['B4']}; pair_overflow "
        f"{stats['pair_overflow']}, visible_overflow "
        f"{stats['visible_overflow']}, tile_overflow (true count) "
        f"{stats['tile_overflow']}; drawn pixels {drawn:.3f}")
    if launches["B4"] != n:
        raise AssertionError(f"B4 launches on the many_sprites path: "
                             f"{launches}")
    check_stats(app.world.state, ("pair_overflow", "visible_overflow"))
    if drawn < 0.05:
        raise AssertionError("full-size many_sprites frame drew too little")
    with Recorder() as rec_full:
        app.run(max_frames=n, dt=1 / 60)
    torch.cuda.synchronize()
    errs = [compare("B4", a, kw) for a, kw in rec_full.calls["B4"]]
    if len(errs) != n:
        raise AssertionError(f"many_sprites called B4 {len(errs)} times in "
                             f"{n} frames")
    a, kw = rec_full.calls["B4"][-1]
    err = max(errs)
    log(f"B4 at full size: {len(errs)} frames' calls bit-equal to plain "
        f"(max abs err {err}; the last: visible budget {a[1].shape[0]}, "
        f"listed {int(a[4].sum())}, most in a tile {int(a[4].max())})")
    results["B4"] = time_kernel("B4", a, kw, launches["B4"], err)
    del app, rec_full
    torch.cuda.empty_cache()

    # -- B5: variant scenes on the card ------------------------------------
    b5_scenes(dev)

    # -- bevymark at full size: 150 frames of flock, 20 timed ------------
    app = torch_bevymark.build_app(device=dev)
    step = app.frame_fn()
    state = app.world.state
    for _ in range(FLOCK_FRAMES):
        state = step(state)
    app.world.state = state
    ms, launches, stats, _ = timed_frames(app, n)
    birds = app.world.entity_count(torch_bevymark.Bird)
    per_frame = int(min(np.float32(torch_bevymark.SPAWN_PER_SEC) *
                        np.float32(1 / 60), 256))
    want = per_frame * (FLOCK_FRAMES + 3 + n)
    drawn = frame_drawn(app.world.state)
    log(f"bevymark {birds} birds @1280x720: {ms:.3f} ms/frame over {n} "
        f"frames after {FLOCK_FRAMES + 3} (CUDA events; {smi})")
    log(f"launches in those {n} frames: B5 {launches['B5']}; pair_overflow "
        f"{stats['pair_overflow']}, visible_overflow "
        f"{stats['visible_overflow']}; drawn pixels {drawn:.3f}")
    if birds != want:
        raise AssertionError(f"{birds} birds, the spawn budget gives {want} "
                             f"({per_frame} a frame)")
    if launches["B5"] != n:
        raise AssertionError(f"B5 launches on the bevymark path: {launches}")
    check_stats(app.world.state, ("pair_overflow", "visible_overflow"))
    if drawn < 0.05:
        raise AssertionError("full-size bevymark frame drew too little")
    with Recorder() as rec_full:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    a, kw = rec_full.calls["B5"][-1]
    err = compare("B5", a, kw)
    log(f"B5 at full size: bit-equal to plain (max abs err {err}; windows "
        f"{int((a[2][:, 0] >= 0).sum())}, most in an 8-row block "
        f"{int(a[5].max())})")
    results["B5"] = time_kernel("B5", a, kw, launches["B5"], err)
    torch.cuda.synchronize()


def triangle_scene(device, seed=0, n_tris=288):
    """The scene of tests/test_sharded_raster.py on `device`: small random
    front-facing triangles across clip space, ambient-only flat shade
    (cc, cn, ok, mat, light)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.8, 0.8, (n_tris, 1, 2))
    jitter = rng.uniform(0.02, 0.12, (n_tris, 3, 2))
    sign = np.stack([np.zeros((n_tris, 2)),
                     np.asarray([[0.1, 0.0]] * n_tris),
                     np.asarray([[0.0, 0.1]] * n_tris)], 1)
    xy = centers + sign + jitter * 0.3
    z = rng.uniform(0.2, 0.9, (n_tris, 1, 1)).repeat(3, 1)
    cc = np.concatenate([xy, z, np.ones((n_tris, 3, 1))],
                        -1).astype(np.float32)
    e1 = cc[:, 1, :2] - cc[:, 0, :2]
    e2 = cc[:, 2, :2] - cc[:, 0, :2]
    flip = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) < 0
    cc[flip] = cc[flip][:, [0, 2, 1]]
    cn = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (n_tris, 3, 1))
    mat = np.concatenate([rng.uniform(0.2, 1.0, (n_tris, 3)),
                          np.ones((n_tris, 1)), np.zeros((n_tris, 5))],
                         1).astype(np.float32)
    light = np.zeros(16, np.float32)
    light[6:9] = 1.0
    return [torch.tensor(x, device=device)
            for x in (cc, cn, np.ones(n_tris, bool), mat, light)]


TRI_KW = dict(tile_h=32, tile_w=128, max_per_tile=128)
TRI_SCISSOR = (20.5, 10.0, 290.25, 170.0)


def tri_scene(device, seed=0):
    """B7/B8's scene (also tests/test_torch_tris.py's), 320x180: 240
    random triangles of varying size and per-corner w, 20 exact duplicates
    of earlier ones later in the list (equal-depth ties), 150 tiny
    triangles crowding the top-left 32x128 tile past max_per_tile = 128,
    12 off-screen and ~10% back-facing ones; random corner normals,
    colours, emissive, metallic and roughness; a 19-plane framebuffer and
    a depth buffer holding 0.5 on a fifth of the pixels. Returns a dict
    of tensors on `device` (clip (T,3,4), normals (T,3,3), colors (T,4),
    emissive (T,3), metallic, roughness (T,), fb (19,H,W), depth (H,W),
    light (16,))."""
    rng = np.random.default_rng(seed)
    H, W = 180, 320

    def tris(n, lo, hi, size):
        c = rng.uniform(lo, hi, (n, 1, 2)) * rng.choice([-1.0, 1.0],
                                                         (n, 1, 2))
        return c + rng.uniform(-size, size, (n, 3, 2))

    ndc = np.concatenate([
        tris(240, 0.0, 1.1, 0.3),
        np.stack([rng.uniform(-1.0, -0.26, (150, 1)),
                  rng.uniform(0.7, 1.0, (150, 1))], -1)
        + rng.uniform(-0.03, 0.03, (150, 3, 2)),
        tris(12, 1.6, 3.0, 0.2)])
    e1, e2 = ndc[:, 1] - ndc[:, 0], ndc[:, 2] - ndc[:, 0]
    # counter-clockwise in NDC (y up) is front-facing; flip all but ~10%
    back = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) < 0
    flip = back & (rng.uniform(size=len(ndc)) > 0.1)
    ndc[flip] = ndc[flip][:, [0, 2, 1]]
    w = rng.uniform(1.0, 4.0, (len(ndc), 3, 1))
    z = rng.uniform(0.05, 0.95, (len(ndc), 3, 1))
    clip = np.concatenate([ndc * w, z * w, w], -1)
    clip = np.concatenate([clip[:240], clip[rng.choice(240, 20, False)],
                           clip[240:]])
    n = clip.shape[0]
    nrm = rng.normal(size=(n, 3, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    fb = rng.uniform(0.0, 1.0, (19, H, W))
    depth = np.where(rng.uniform(size=(H, W)) < 0.2, 0.5, 0.0)
    light = np.zeros(16)
    light[:9] = [0.3, -0.8, -0.5, 1.0, 0.9, 0.8, 0.1, 0.1, 0.13]
    out = dict(clip=clip, normals=nrm, colors=rng.uniform(0.1, 1.0, (n, 4)),
               emissive=rng.uniform(0.0, 0.2, (n, 3)),
               metallic=rng.uniform(0.0, 1.0, n),
               roughness=rng.uniform(0.1, 1.0, n), fb=fb, depth=depth,
               light=light)
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in out.items()}


def tri_scene_calls(dev):
    """The six raster_tris instantiations (layout x scissor) on tri_scene
    with_slivers, moved to `dev`: a list of (args, kwargs), binned with
    bin_tris."""
    from torch_scenes import with_slivers

    from bevy_tpu_torch.ops import raster3d as r3
    from bevy_tpu_torch.ops import raster3d_tris as rt
    s = tri_scene(dev)
    H, W = s["depth"].shape
    active = torch.ones(s["clip"].shape[0], dtype=torch.bool, device=dev)
    setup, s = with_slivers(r3.triangle_setup_corners(s["clip"], active,
                                                      W, H), s)
    pair_tri, starts, counts, _ = rt.bin_tris(setup["valid"], setup["aabb"],
                                              H, W, **TRI_KW)
    tables = {"corners": rt.pack_tri_table(setup, s["normals"], s["colors"],
                                           s["emissive"])}
    tables["planes"] = tables["planes_gbuf"] = rt.pack_tri_planes(
        setup["corners"], setup["depth"], setup["inv_w"], setup["area2"],
        setup["valid"], s["normals"], s["colors"], s["emissive"],
        s["metallic"], s["roughness"])
    calls = []
    for layout, table in tables.items():
        fb = s["fb"] if layout == "planes_gbuf" else s["fb"][:4].contiguous()
        for sc in (None, TRI_SCISSOR):
            calls.append(((fb, s["depth"], table, pair_tri, starts, counts,
                           s["light"], sc),
                          dict(tile_h=TRI_KW["tile_h"],
                               tile_w=TRI_KW["tile_w"], layout=layout)))
    return calls


COMPOSITE_KW = dict(win_h=16, cs=12)


def composite_scene(device, negative=False):
    """B6's scene (also tests/test_torch_package.py's): 12 packed windows of
    16 rows at 4 depth levels, overlapping at unaligned rows and running
    past the frame's right and bottom edges, an invalid tail, and an
    incoming depth that ties a window value; with `negative`, a third of
    the incoming depths below 0 (and a tenth -0.0), where empty window
    pixels (0) beat the depth. Returns the inputs (depth, winner, windows,
    owner, meta, wvalid) on `device`; call with COMPOSITE_KW."""
    rng = np.random.RandomState(2)
    H, W, nb = 40, 200, 12
    win_h = COMPOSITE_KW["win_h"]
    levels = np.array([0.0, 0.25, 0.5, 0.75], np.float32)
    z = levels[rng.randint(0, 4, (nb, win_h, 128))]
    ids = rng.randint(0, 16, z.shape).astype(np.int32)
    windows = np.where(z > 0, ((z.view(np.int32) & ~15) | ids).view(
        np.float32), 0.0).astype(np.float32)
    col = rng.randint(0, 2, nb)
    y0 = rng.randint(0, H - win_h + 8, nb)          # some run off the bottom
    meta = (col * 2048 + y0).astype(np.int32)
    owner = rng.randint(0, 50, nb).astype(np.int32)
    wvalid = np.arange(nb) < nb - 2
    tie = windows[windows > 0][0]         # the incoming value ties windows
    depth = np.where(rng.uniform(size=(H, W)) < 0.3, tie,
                     0.0).astype(np.float32)
    winner = np.full((H, W), -1.0, np.float32)
    if negative:
        u = rng.uniform(size=(H, W))
        depth = np.where(u < 0.3, -rng.uniform(0.01, 1, (H, W)),
                         np.where(u < 0.4, -0.0, depth)).astype(np.float32)
    return [torch.from_numpy(x).to(device)
            for x in (depth, winner, windows, owner, meta, wvalid)]


def image_diff(a, b):
    """Pixels (of H x W) whose sRGB u8 colour differs, and the largest
    channel difference."""
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    return int((d > 0).sum()), int(d.max())


def sharded_cubes_phases(dev, n, smi, results, full_img, b2_px):
    """Phases 15-17: B6 against plain on the test scenes, the sharded
    many_cubes twin against the unsharded one at the JAX test's
    configuration, and the full-size sharded frame (`full_img`: the
    unsharded full-size frame after as many frames; `b2_px`: the pixels
    its fallback clusters drew through B2, which the sharded path does
    not draw)."""
    import torch_many_cubes
    from bevy_tpu_torch.parallel import make_mesh
    from bevy_tpu_torch.parallel.raster import sharded_flat_raster
    from bevy_tpu_torch.render import frame_image

    for name, neg in (("overlapping and tying windows", False),
                      ("the same over depths below 0", True)):
        a = composite_scene(dev, negative=neg)
        err = compare("B6", a, COMPOSITE_KW)
        log(f"B6 vs plain, {name}: bit-equal (max abs err {err})")
        b6_work_line(name, a, COMPOSITE_KW)
    mesh8 = make_mesh(devices=[dev] * 8)
    log(f"shards on this run's one card: {mesh8}")
    kw = dict(width=128, height=64, cluster_size=12, win_h=16,
              visible_budget=64, window_budget=2048)
    one = sharded_flat_raster(make_mesh(devices=[dev]), *triangle_scene(dev),
                              **kw)
    with Recorder() as rec:
        eight = sharded_flat_raster(mesh8, *triangle_scene(dev), **kw)
    torch.cuda.synchronize()
    errs = [compare("B6", a, k) for a, k in rec.calls["B6"]]
    if len(errs) != 8:
        raise AssertionError(f"8 shards made {len(errs)} B6 calls")
    if not torch.equal(one[0], eight[0]) or \
            not torch.allclose(one[1], eight[1], atol=5e-5):
        raise AssertionError("sharded flat raster: 8 shards != 1 shard")
    log(f"B6 vs plain, sharded flat raster scene: {len(errs)} calls "
        f"bit-equal (max abs err {max(errs)}); 8-shard colour == 1-shard, "
        f"covered {float((eight[1] > 0).float().mean()):.3f}")

    cfg = dict(n_cubes=512, width=256, height=128, capacity=1024,
               window_budget=8192, cull_budget=None, device=dev)
    single = torch_many_cubes.build_app(**cfg)
    single.run(max_frames=2, dt=1 / 60)
    sharded = torch_many_cubes.build_app(shards=mesh8, **cfg)
    with Recorder() as rec:
        sharded.run(max_frames=2, dt=1 / 60)
    torch.cuda.synchronize()
    errs = [compare("B6", a, k) for a, k in rec.calls["B6"]]
    if len(errs) != 2 * 2 * 8 or rec.calls["B1"] or rec.calls["B2"]:
        raise AssertionError(f"sharded many_cubes: {len(errs)} B6 calls, "
                             f"{len(rec.calls['B1'])} B1")
    nd, mx = image_diff(frame_image(single), frame_image(sharded))
    log(f"B6 vs plain, sharded many_cubes (512 cubes, 256x128, 8 shards, 2 "
        f"frames): {len(errs)} calls bit-equal (max abs err {max(errs)}); "
        f"image vs unsharded: {nd} pixels differ (max {mx})")
    if nd:
        raise AssertionError("sharded many_cubes image != unsharded")
    del single, sharded, rec

    mesh4 = make_mesh(devices=[dev] * 4)
    app = torch_many_cubes.build_app(shards=mesh4, device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_cubes 160000 @1280x720, {mesh4.size} shards: {ms:.3f} "
        f"ms/frame over {n} frames (CUDA events; {smi})")
    with Recorder() as rec_full:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    img = frame_image(app)
    nd, mx = image_diff(full_img, img)
    outside = int(((np.abs(full_img.astype(int) - img).max(-1) > 0)
                   & ~b2_px).sum())
    log(f"pixels differing from the unsharded frame outside its B2 "
        f"(fallback) footprint of {int(b2_px.sum())} pixels: {outside}")
    log(f"launches in those {n} frames: B6 {launches['B6']} (predicted "
        f"{2 * mesh4.size * n}), B1 {launches['B1']}, B2 {launches['B2']}; "
        f"pair_overflow {stats['pair_overflow']} (fallback clusters "
        f"included), fallback clusters {stats['fallback_clusters'] / n}"
        f"/frame (not drawn when sharded); covered pixels {covered:.3f}; "
        f"pixels differing from the unsharded frame {nd} of "
        f"{full_img.shape[0] * full_img.shape[1]} (max channel diff {mx})")
    if launches["B6"] != 2 * mesh4.size * n or launches["B1"] or \
            launches["B2"]:
        raise AssertionError(f"launches on the sharded many_cubes path: "
                             f"{launches}")
    if stats["pair_overflow"] != stats["fallback_clusters"]:
        raise AssertionError(
            f"windows dropped on the sharded many_cubes path: pair_overflow "
            f"{stats['pair_overflow']}, fallback clusters "
            f"{stats['fallback_clusters']}")
    if covered < 0.05:
        raise AssertionError("full-size sharded frame drew (almost) nothing")
    # every B6 call of the frame (2 classes x 4 shards), then the one with
    # the most valid windows timed
    calls = rec_full.calls["B6"]
    if len(calls) != 2 * mesh4.size:
        raise AssertionError(f"one sharded frame made {len(calls)} B6 calls")
    errs = []
    for i, (a, kw) in enumerate(calls):
        errs.append(compare("B6", a, kw))
        b6_work_line(f"full size, call {i + 1} of {len(calls)}", a, kw)
    a, kw = max(calls, key=lambda c: int(c[0][5].sum()))
    err = max(errs)
    log(f"B6 at full size: {len(calls)} calls bit-equal to plain (max abs "
        f"err {err}); timed: {int(a[5].sum())} valid windows of "
        f"{a[5].shape[0]}, win_h {kw['win_h']}")
    results["B6"] = time_kernel("B6", a, kw, launches["B6"], err,
                                library=library_b6(a, kw))
    # the other window class's largest call
    other = [c for c in calls if c[1]["win_h"] != kw["win_h"]]
    if other:
        a, kw = max(other, key=lambda c: int(c[0][5].sum()))
        d_ms, rows = device_ms(lambda: kernel_fn("B6")(*a, **kw))
        log(f"B6 device time, the win_h {kw['win_h']} class's largest call "
            f"({int(a[5].sum())} valid windows): {d_ms:.4f} ms; by kernel "
            f"(torch.profiler): " + "; ".join(
                f"{name[:60]} {ms:.4f} ms" for name, ms in rows[:3]))
    del app, rec_full
    torch.cuda.empty_cache()


def sharded_lights_phases(dev, n, smi, golden_img, full_img):
    """Phases 18-19: the many_lights golden configuration and the full-size
    frame with a 4-band shade, against the golden and the unsharded
    images (`golden_img`, `full_img`: after as many frames)."""
    import torch_many_lights
    from bevy_tpu_torch.parallel import make_mesh
    from bevy_tpu_torch.render import frame_image

    mesh4 = make_mesh(devices=[dev] * 4)
    lapp = torch_many_lights.build_app(device=dev, shards=mesh4,
                                       **LIGHTS_GOLDEN_KW)
    with Recorder() as rec:
        lapp.update(dt=1 / 60)
    torch.cuda.synchronize()
    if len(rec.calls["B3"]) != mesh4.size:
        raise AssertionError(f"{len(rec.calls['B3'])} B3 calls, one a band "
                             f"wanted")
    for kid in ("B1", "B2", "B3"):
        errs = [compare(kid, a, kw) for a, kw in rec.calls[kid]]
        errs = [e[0] if kid == "B3" else e for e in errs]
        log(f"{kid} vs plain, sharded lights golden scene ({mesh4.size} "
            f"bands): {len(errs)} calls (max abs err {max(errs)})")
    img = frame_image(lapp)
    check_golden(img, LIGHTS_GOLDEN)
    nd, mx = image_diff(golden_img, img)
    log(f"sharded lights golden scene vs unsharded: {nd} pixels differ "
        f"(max {mx})")
    if nd:
        raise AssertionError("sharded lights image != unsharded")
    del lapp, rec

    app = torch_many_lights.build_app(device=dev, shards=mesh4)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_lights 100000 @1280x720, {mesh4.size}-band shade: {ms:.3f} "
        f"ms/frame over {n} frames (CUDA events; {smi})")
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    if len(rec.calls["B3"]) != mesh4.size:
        raise AssertionError(f"{len(rec.calls['B3'])} B3 calls in a "
                             f"full-size frame, one a band wanted")
    for a, kw in rec.calls["B3"]:
        err = compare("B3", a, kw)
        log(f"B3 vs plain, full-size band at row {int(a[4][34])} "
            f"({a[0].shape[1]} rows, F={a[2].shape[1]}, lights listed "
            f"{int(a[3].sum())}): max abs err {err[0]}, max rel err "
            f"{err[1]}, {err[2]} values differ")
        b3_cull_line(f"full-size band at row {int(a[4][34])}", a, kw)
    nd, mx = image_diff(full_img, frame_image(app))
    log(f"launches in those {n} frames: B1 {launches['B1']}, B2 "
        f"{launches['B2']}, B3 {launches['B3']} (predicted "
        f"{mesh4.size * n}); light_pair_overflow "
        f"{stats['light_pair_overflow']}, light_tile_overflow "
        f"{stats['light_tile_overflow'] / n}/frame, pair_overflow "
        f"{stats['pair_overflow']}; covered pixels {covered:.3f}; pixels "
        f"differing from the unsharded frame {nd} (max channel diff {mx})")
    if launches["B3"] != mesh4.size * n or not launches["B1"] or \
            not launches["B2"]:
        raise AssertionError(f"launches on the sharded many_lights path: "
                             f"{launches}")
    if covered < 0.5:
        raise AssertionError("full-size sharded many_lights drew too little")
    if nd:
        raise AssertionError("full-size sharded many_lights image != "
                             "unsharded")
    del app, rec
    torch.cuda.empty_cache()


def cubes_batch(app):
    """Batched-uniform geometry of a many_cubes world for
    raster_batched_legacy: every cube's clip-space corners (Ni, 24, 4) and
    world normals (Ni, 24, 3) under the world's camera, the cuboid's
    triangles, instance validity, colour, emissive, metallic and
    roughness, and the (16,) light vector of its light and ambient."""
    from bevy_tpu_torch.ecs.component import get_spec
    from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
    from bevy_tpu_torch.math.quat import quat_rotate_vec3
    from bevy_tpu_torch.render.camera import (
        Camera3d, perspective_infinite_reverse, view_matrix)
    from bevy_tpu_torch.render.mesh import cuboid
    from bevy_tpu_torch.render.mesh3d import (
        AmbientLight, DirectionalLight, Mesh3d, MeshMaterial)
    from bevy_tpu_torch.transform import GlobalTransform
    w = app.world
    dev = w.device
    H, W = w.state["res"]["render_target"]["depth"].shape
    gt = {f: w.column(GlobalTransform, f)
          for f in ("translation", "rotation", "scale")}
    ci = int(w.query_rows(Camera3d)[0])
    li = int(w.query_rows(DirectionalLight)[0])
    rows = torch.as_tensor(w.query_rows(Mesh3d), device=dev)
    vp = perspective_infinite_reverse(
        w.column(Camera3d, "fov")[ci], W / H,
        w.column(Camera3d, "near")[ci]) @ view_matrix(
            gt["translation"][ci], gt["rotation"][ci], gt["scale"][ci])
    mats = trs_to_mat4(TRS(translation=gt["translation"][rows],
                           rotation=gt["rotation"][rows],
                           scale=gt["scale"][rows]))
    m = cuboid()
    ph = torch.as_tensor(np.concatenate(
        [m.positions, np.ones((m.num_vertices, 1), np.float32)], 1),
        device=dev)
    clip = torch.einsum("nij,vj->nvi", torch.einsum("ij,njk->nik", vp, mats),
                        ph)
    nrm = quat_rotate_vec3(gt["rotation"][rows][:, None, :],
                           torch.as_tensor(m.normals, device=dev)[None])
    amb = w.state["res"][get_spec(AmbientLight).name]
    fwd = torch.tensor([0.0, 0.0, -1.0], device=dev)
    light = torch.cat([
        quat_rotate_vec3(gt["rotation"][li], fwd),
        w.column(DirectionalLight, "color")[li] *
        w.column(DirectionalLight, "illuminance")[li],
        amb["color"] * amb["brightness"], torch.zeros(7, device=dev)])
    return dict(clip=clip, nrm=nrm, triangles=m.triangles,
                inst_ok=torch.ones(len(rows), dtype=torch.bool, device=dev),
                col_i=w.column(MeshMaterial, "base_color")[rows],
                emi_i=w.column(MeshMaterial, "emissive")[rows],
                met_i=w.column(MeshMaterial, "metallic")[rows],
                rgh_i=w.column(MeshMaterial, "perceptual_roughness")[rows],
                light=light, size=(H, W))


def fox_phases(dev, n, smi):
    """Phases 25-27: the many_foxes slice (skinned meshes on the shade
    records) and the group route's shade-record worlds."""
    import torch_many_foxes
    from torch_many_cubes import profile
    from torch_scenes import port_scene_modules, shade_record_world
    from bevy_tpu_torch.render import frame_image

    # -- 25: the fox golden configuration ---------------------------------
    fapp = torch_many_foxes.build_app(device=dev, **FOX_GOLDEN_KW)
    with Recorder() as rec:
        fapp.run(max_frames=8, dt=1 / 60)
    torch.cuda.synchronize()
    for kid, per_frame in (("B1", 2), ("B2", 1)):
        if len(rec.calls[kid]) != 8 * per_frame:
            raise AssertionError(f"fox golden scene: {len(rec.calls[kid])} "
                                 f"{kid} calls in 8 frames")
        errs = [compare(kid, a, kw) for a, kw in rec.calls[kid]]
        log(f"{kid} vs plain, fox golden scene: {len(errs)} calls bit-equal "
            f"(max abs err {max(errs)})")
    for a, kw in rec.calls["B1"][-2:]:
        b1_cull_line("fox golden scene, frame 8", a, kw)
    check_golden(frame_image(fapp), FOX_GOLDEN)
    check_stats(fapp.world.state, ("pair_overflow", "tile_overflow"))
    del fapp, rec

    # -- 26: the full-size many_foxes frame --------------------------------
    app = torch_many_foxes.build_app(device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_foxes 1000 @1280x720: {ms:.3f} ms/frame over {n} frames "
        f"(CUDA events; {smi})")
    others = sum(v for k, v in launches.items() if k not in ("B1", "B2"))
    log(f"launches in those {n} frames: B1 {launches['B1']}, B2 "
        f"{launches['B2']}, the others {others}; "
        f"fallback clusters to B2 {stats['fallback_clusters'] / n}/frame; "
        f"pair_overflow {stats['pair_overflow']}, tile_overflow "
        f"{stats['tile_overflow']}; covered pixels {covered:.3f}")
    if launches["B1"] != 2 * n or launches["B2"] != n or others:
        raise AssertionError(f"launches on the many_foxes path: {launches}")
    if covered < 0.02:
        raise AssertionError("full-size many_foxes frame drew (almost) "
                             "nothing")
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    for kid in ("B1", "B2"):
        errs = [compare(kid, a, kw) for a, kw in rec.calls[kid]]
        log(f"{kid} vs plain, many_foxes full size: {len(errs)} calls "
            f"bit-equal (max abs err {max(errs)})")
    for a, kw in rec.calls["B1"]:
        b1_cull_line("many_foxes full size", a, kw)
        time_kernel("B1", a, kw, 2 * n, compare("B1", a, kw),
                    where=f"in the many_foxes frame (win_h {kw['win_h']})")
    a, kw = rec.calls["B2"][-1]
    b2_cull_line("many_foxes full size", a, kw)
    time_kernel("B2", a, kw, n, compare("B2", a, kw),
                where="in the many_foxes frame")
    log("many_foxes frame by span (torch.profiler, 10 frames):")
    profile(app.frame_fn(), app.world.state, 10)
    del app, rec
    torch.cuda.empty_cache()

    # -- 27: textured / normal-mapped / parallax and smooth worlds --------
    mods = port_scene_modules()
    for kind in ("atlas", "smooth"):
        with Recorder() as rec:
            img, _ = shade_record_world(mods, kind, {"device": dev}, {})
        torch.cuda.synchronize()
        cpu_img, _ = shade_record_world(mods, kind, {"device": "cpu"}, {})
        d = np.abs(img - cpu_img).max(-1)
        frac = float((d > 8).mean())
        log(f"shade-record world {kind!r} on the card vs the CPU: "
            f"{frac:.4%} of pixels drift > 8 (max channel diff {d.max()}, "
            f"{int((d > 0).sum())} pixels differ)")
        if frac >= 0.01:
            raise AssertionError(f"shade-record world {kind!r} differs from "
                                 f"the CPU frame")
        for kid in ("B1", "B2"):
            errs = [compare(kid, a, kw) for a, kw in rec.calls[kid]]
            if not errs:
                raise AssertionError(f"world {kind!r} never called {kid}")
            log(f"{kid} vs plain, shade-record world {kind!r}: {len(errs)} "
                f"calls bit-equal (max abs err {max(errs)})")


SHADOW_SMALL = dict(width=160, height=96, size=256, cascades=4,
                    extent=48.0, distance=80.0, spot_size=256, point=True,
                    point_size=256, grid=4, near_casters=True)
SHADOW_FULL = dict(width=1280, height=720, size=2048, cascades=4,
                   extent=48.0, distance=80.0, spot_size=1024, point=True,
                   point_size=1024, grid=100, near_casters=True)


def near_caster_entries(app, calls, shape):
    """The near-plane straddlers' share of B2 in the shadow passes: the
    (tile, cluster) entries that the B2 calls at `shape` (the spot map and
    the point faces) list in the recorded `calls` of one frame, and in
    one more frame with the straddlers (the 4 cm cubes of the showcase's
    near_casters) moved 500 m above the scene, out of the spot's view and
    the point light's near planes (a data change: the same groups).
    Returns (entries, entries without them, number moved)."""
    from bevy_tpu_torch.render.mesh3d import Mesh3d
    from bevy_tpu_torch.transform import Transform, transform_bundle

    def entries(rec_calls):
        return sum(int(a[4].sum()) for a, _ in rec_calls
                   if tuple(a[0].shape) == shape)

    rows = app.world.query_rows(Mesh3d)
    scale = app.world.column(Transform, "scale").cpu().numpy()[rows, 0]
    near = rows[np.isclose(scale, 0.04)]
    for r in near:
        app.world.insert(int(r), *transform_bundle(
            translation=(0.0, 500.0, 0.0), scale=(0.04, 0.04, 0.04)))
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    return entries(calls), entries(rec.calls["B2"]), len(near)


def shadow_phases(dev, n, smi):
    """Phases 28-30: the shadow showcase (cascaded directional, spot and
    point shadow maps on B1/B2, the shadow plane, specular tint and
    anisotropy into B3)."""
    import torch_shadow_showcase
    from torch_many_cubes import profile
    from bevy_tpu_torch.render import frame_image

    def by_map(calls):
        """Recorded calls by their depth buffer's shape: the directional
        cascades (2048^2 / 256^2), the spot map and point faces, the
        frame."""
        out = {}
        for a, kw in calls:
            out.setdefault(tuple(a[0].shape), []).append((a, kw))
        return out

    # -- 28: the small showcase frame, the card against the CPU -----------
    with Recorder() as rec:
        app = torch_shadow_showcase.build_app(device=dev, **SHADOW_SMALL)
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    img = frame_image(app)
    cpu = torch_shadow_showcase.build_app(device="cpu", **SHADOW_SMALL)
    cpu.update(dt=1 / 60)
    d = np.abs(img.astype(int) - frame_image(cpu).astype(int)).max(-1)
    frac = float((d > 8).mean())
    log(f"shadow showcase 160x96 (maps 256, 4 cascades, spot, point, 4x4 "
        f"grid) on the card vs the CPU: {frac:.4%} of pixels drift > 8 "
        f"(max channel diff {d.max()}, {int((d > 0).sum())} pixels differ)")
    if frac >= 0.01:
        raise AssertionError("the small shadow frame differs from the CPU's")
    for kid in ("B1", "B2"):
        errs = [compare(kid, a, kw) for a, kw in rec.calls[kid]]
        log(f"{kid} vs plain, small shadow frame: {len(errs)} calls "
            f"bit-equal (max abs err {max(errs)})")
    for a, kw in rec.calls["B3"]:
        err = compare("B3", a, kw)
        log(f"B3 vs plain, small shadow frame (shadow plane, anisotropy "
            f"{kw['anisotropy']}, specular tint {kw['specular_tint']}): "
            f"within rtol/atol 1e-5 (max abs err {err[0]}, max rel err "
            f"{err[1]}, {err[2]} values differ)")
    check_stats(app.world.state, ("pair_overflow", "tile_overflow"))
    del app, cpu, rec

    # -- 29: the full-size shadow world -----------------------------------
    app = torch_shadow_showcase.build_app(device=dev, **SHADOW_FULL)
    ms, launches, stats, covered = timed_frames(app, n)
    per = {k: launches[k] / n for k in ("B1", "B2", "B3")}
    others = sum(v for k, v in launches.items() if k not in per)
    log(f"shadow showcase @1280x720 (10,000 grid casters, 4 x 2048^2 "
        f"cascades, a 1024^2 spot map, 6 x 1024^2 point faces): {ms:.3f} "
        f"ms/frame over {n} frames (CUDA events; {smi})")
    log(f"launches a frame ({smi}): B1 {per['B1']}, B2 {per['B2']}, B3 "
        f"{per['B3']}, the others {others}; fallback clusters to B2 "
        f"{stats['fallback_clusters'] / n}/frame; pair_overflow "
        f"{stats['pair_overflow']}, tile_overflow {stats['tile_overflow']}, "
        f"light_pair_overflow {stats['light_pair_overflow']}; covered "
        f"pixels {covered:.3f}")
    # 12 passes (11 depth-only + the G-buffer) x 2 mesh groups
    if per != {"B1": 48.0, "B2": 24.0, "B3": 1.0} or others:
        raise AssertionError(f"launches on the shadow path: {launches}")
    check_stats(app.world.state, ("pair_overflow", "tile_overflow",
                                  "light_pair_overflow"))
    if covered < 0.5:
        raise AssertionError("the full-size shadow frame drew too little")
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    for kid in ("B1", "B2"):
        for shape, calls in sorted(by_map(rec.calls[kid]).items()):
            errs = [compare(kid, a, kw) for a, kw in calls]
            lists = "" if kid == "B1" else \
                f", (tile, cluster) entries {[int(a[4].sum()) for a, _ in calls]}"
            log(f"{kid} vs plain, shadow frame, {shape[0]}x{shape[1]}: "
                f"{len(errs)} calls bit-equal (max abs err {max(errs)})"
                f"{lists}")
    state = app.world.state["res"]["render_target"]
    maps_ok = all(bool(torch.isfinite(state[k]).all()) and
                  bool((state[k] > 0).any())
                  for k in ("shadow_depth", "spot_shadow_depth",
                            "point_shadow_depth"))
    if not maps_ok:
        raise AssertionError("a shadow map is empty or not finite")
    log(f"maps: shadow_depth {tuple(state['shadow_depth'].shape)}, "
        f"spot {tuple(state['spot_shadow_depth'].shape)}, point "
        f"{tuple(state['point_shadow_depth'].shape)}; covered "
        + ", ".join(f"{k} {float((state[k] > 0).float().mean()):.3f}"
                    for k in ("shadow_depth", "spot_shadow_depth",
                              "point_shadow_depth")))
    # -- 30: B1, B2, B3 at the shadow frame's shapes ----------------------
    # each kernel's busiest call (most valid windows / listed clusters) on
    # a 2048^2 cascade and on a 1024^2 spot / point map
    work = {"B1": lambda c: int(c[0][5].sum()),
            "B2": lambda c: int(c[0][4].sum())}
    for kid, cull_line in (("B1", b1_cull_line), ("B2", b2_cull_line)):
        maps = by_map(rec.calls[kid])
        for shape in ((2048, 2048), (1024, 1024)):
            a, kw = max(maps[shape], key=work[kid])
            where = (f"in the shadow frame's busiest {shape[0]}^2 map call "
                     f"({work[kid]((a, kw))} "
                     + ("windows" if kid == "B1" else "(tile, cluster) "
                        "entries") + f"; {smi})")
            cull_line(f"shadow frame, busiest {shape[0]}^2 map", a, kw)
            time_kernel(kid, a, kw, launches[kid], compare(kid, a, kw),
                        where=where)
    a, kw = rec.calls["B3"][-1]
    if a[5] is None or not (kw["anisotropy"] and kw["specular_tint"]):
        raise AssertionError(f"the shadow frame's B3 call lacked the "
                             f"shadow plane or a variant: {kw}")
    err = compare("B3", a, kw)
    log(f"B3 vs plain, shadow frame (shadow plane + anisotropy + specular "
        f"tint, {a[0].shape[0]} planes): within rtol/atol 1e-5 (max abs "
        f"err {err[0]}, max rel err {err[1]}, {err[2]} values differ)")
    time_kernel("B3", a, kw, launches["B3"], err[0],
                where=f"in the shadow frame (shadow plane, anisotropy, "
                      f"specular tint; {smi})")
    log("shadow frame by span (torch.profiler, 10 frames):")
    profile(app.frame_fn(), app.world.state, 10)
    # the straddlers reach B2 inside the spot and point passes: the 1024^2
    # B2 calls list more entries with them than without (their calls are
    # held bit-equal above)
    with_near, without, moved = near_caster_entries(app, rec.calls["B2"],
                                                    (1024, 1024))
    log(f"near-plane casters in the 1024^2 shadow passes: {moved} moved "
        f"out, B2 (tile, cluster) entries {with_near} with them, {without} "
        f"without")
    if moved != 2 or not with_near > without:
        raise AssertionError("the near-plane casters never reached B2 in a "
                             "spot or point shadow pass")
    del app, rec
    torch.cuda.empty_cache()


def tri_phases(dev, n, smi, results):
    """Phases 20-24: B7 and B8 against plain on the CPU test scene, the
    cubes_f3 and shapes_f1 goldens through the general route, many_cubes
    160k and 3d_shapes at 1280x720 through it, and raster_batched_legacy
    (B8) forward and deferred on the 160k cubes (entries of `results`)."""
    from types import SimpleNamespace

    import torch_3d_shapes
    import torch_many_cubes
    from bevy_tpu_torch.render import frame_image
    from bevy_tpu_torch.render import mesh3d

    # -- 20: B7 / B8, all six instantiations, on the CPU test scene -------
    for a, kw in tri_scene_calls(dev):
        kid = kernel_id(kernel_fn("B7"), kw)
        err = compare(kid, a, kw)
        name = f"test scene ({kw['layout']}, scissor " \
            f"{'on' if a[7] else 'off'})"
        log(f"{kid} vs plain, {name}: bit-equal (max abs err {err})")
        tri_cull_line(kid, name, work_tris(a, kw))

    # -- 21: the cubes_f3 golden through backend="xla" --------------------
    app = torch_many_cubes.build_app(n_cubes=300, width=320, height=180,
                                     capacity=512, backend="xla", device=dev)
    with Recorder() as rec:
        app.run(max_frames=3, dt=1 / 60)
    torch.cuda.synchronize()
    errs = [compare("B7", a, kw) for a, kw in rec.calls["B7"]]
    if len(errs) != 3:
        raise AssertionError(f"cubes_f3 called B7 {len(errs)} times")
    log(f"B7 vs plain, cubes_f3 scene: {len(errs)} calls bit-equal (max abs "
        f"err {max(errs)})")
    for i, (a, kw) in enumerate(rec.calls["B7"]):
        tri_cull_line("B7", f"cubes_f3 scene, frame {i + 1}",
                      work_tris(a, kw))
    check_golden(frame_image(app), CUBES_XLA_GOLDEN)
    check_stats(app.world.state, ("pair_overflow", "tile_overflow"))

    # -- 22: the shapes_f1 golden (3d_shapes twin, 320x180) ---------------
    app = torch_3d_shapes.build_app(width=320, height=180, device=dev)
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    errs = [compare("B7", a, kw) for a, kw in rec.calls["B7"]]
    if len(errs) != 1:
        raise AssertionError(f"shapes_f1 called B7 {len(errs)} times")
    log(f"B7 vs plain, shapes_f1 scene: bit-equal (max abs err {errs[0]})")
    tri_cull_line("B7", "shapes_f1 scene", work_tris(*rec.calls["B7"][0]))
    check_golden(frame_image(app), SHAPES_GOLDEN)
    del app, rec

    # -- 23: full width through the general route -------------------------
    app = torch_many_cubes.build_app(backend="xla", device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_cubes 160000 @1280x720, general route (backend='xla'): "
        f"{ms:.3f} ms/frame over {n} frames (CUDA events; {smi})")
    log(f"launches in those {n} frames: B7 {launches['B7']}; pair_overflow "
        f"{stats['pair_overflow']}, tile_overflow {stats['tile_overflow']} "
        f"({stats['tile_overflow'] / n}/frame); covered pixels "
        f"{covered:.3f}")
    if launches["B7"] != n:
        raise AssertionError(f"B7 launches on the general route: {launches}")
    if covered < 0.05:
        raise AssertionError("full-size general-route frame drew too little")
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    a, kw = rec.calls["B7"][-1]
    err = compare("B7", a, kw)
    log(f"B7 at full size: bit-equal to plain (max abs err {err}; "
        f"{a[2].shape[0]} triangle rows, listed {int(a[5].sum())}, most in "
        f"a tile {int(a[5].max())})")
    results["B7"] = time_kernel("B7", a, kw, launches["B7"], err)
    batch = cubes_batch(app)
    del app, rec
    torch.cuda.empty_cache()

    app = torch_3d_shapes.build_app(width=1280, height=720, device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"3d_shapes @1280x720, general route: {ms:.3f} ms/frame over {n} "
        f"frames (CUDA events; {smi}); B7 {launches['B7']} launches, "
        f"pair_overflow {stats['pair_overflow']}, tile_overflow "
        f"{stats['tile_overflow']} ({stats['tile_overflow'] / n}/frame); "
        f"covered pixels {covered:.3f}")
    if launches["B7"] != n:
        raise AssertionError(f"B7 launches in 3d_shapes: {launches}")
    del app

    # -- 24: raster_batched_legacy (B8) on the 160k cubes -----------------
    H, W = batch["size"]
    kw = dict(width=W, height=H, tile_h=16, tile_w=128, pairs_per_tri=2,
              max_per_tile=3072, interpret=False, met_i=batch["met_i"],
              rgh_i=batch["rgh_i"])
    args = [batch[k] for k in ("clip", "nrm", "triangles", "inst_ok",
                               "col_i", "emi_i", "light")]

    def legacy(deferred):
        target = SimpleNamespace(
            color=torch.zeros((4, H, W), device=dev),
            gbuffer=torch.zeros((19, H, W), device=dev),
            depth=torch.zeros((H, W), device=dev))
        st = SimpleNamespace(
            pair_overflow=torch.zeros((), dtype=torch.int32, device=dev),
            tile_overflow=torch.zeros((), dtype=torch.int32, device=dev))
        mesh3d.raster_batched_legacy(*args, target, st, deferred=deferred,
                                     **kw)
        return target, st

    reset_launches()
    with Recorder() as rec:
        outs = [legacy(False), legacy(True)]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["B8"] != 2:
        raise AssertionError(f"B8 launches in the two legacy calls: "
                             f"{launches}")
    for (target, st), (a, kw8) in zip(outs, rec.calls["B8"]):
        err = compare("B8", a, kw8)
        drawn = float((target.depth > 0).float().mean())
        ms_call = cuda_ms(lambda: legacy(kw8["layout"] == "planes_gbuf"), 5)
        log(f"raster_batched_legacy ({kw8['layout']}) on 160000 cubes "
            f"@1280x720: {ms_call:.3f} ms a call (CUDA events; {smi}); B8 "
            f"bit-equal to plain (max abs err {err}); pair_overflow "
            f"{int(st.pair_overflow)}, tile_overflow "
            f"{int(st.tile_overflow)}; covered pixels {drawn:.3f}")
        if drawn < 0.05:
            raise AssertionError("raster_batched_legacy drew too little")
        if kw8["layout"] == "planes":
            results["B8"] = time_kernel("B8", a, kw8, launches["B8"], err)
        else:
            g_ms = cuda_ms(lambda: kernel_fn("B8")(*a, **kw8), 20)
            b_ms, by, extra = bound_tris(a, kw8)
            log(f"B8 planes_gbuf at full size: kernel {g_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by}, {extra})")
    torch.cuda.synchronize()


def cull_totals(kid, calls):
    """B4 / B5 cull counts summed over recorded calls (work_b4 / work_b5:
    the pairs the old walk reaches, the cull keeps, covered, and dropped
    but covered, which must be 0)."""
    work = work_b4 if kid == "B4" else work_b5
    tot = {}
    for a, kw in calls:
        for k, v in work(a, kw).items():
            tot[k] = tot.get(k, 0) + v
    if tot["dropped"]:
        raise AssertionError(f"{kid}'s cull dropped {tot['dropped']} "
                             f"covered pairs")
    return tot


def check_kernel_calls(name, rec, kids=("B4", "B5")):
    """Every recorded B4 / B5 call of `rec` against plain, bit for bit,
    with the cull counts summed over the calls; returns the calls' count
    by kernel."""
    out = {}
    for kid in kids:
        calls = rec.calls[kid]
        out[kid] = len(calls)
        if not calls:
            continue
        errs = [compare(kid, a, kw) for a, kw in calls]
        t = cull_totals(kid, calls)
        by = {o: rec.origin[kid].count(o) for o in sorted(set(
            rec.origin[kid]))}
        log(f"{kid} vs plain, {name}: {len(errs)} calls {by} bit-equal (max "
            f"abs err {max(errs)}); cull: pairs the old walk reached "
            f"{t['walked']}, the {'block' if kid == 'B4' else 'warp'} cull "
            f"keeps {t['kept']}, covered {t['covered']}, dropped but "
            f"covered {t['dropped']}")
    return out


STATS_2D = ("pair_overflow", "tile_overflow", "visible_overflow")
GIZMO_STATS = ("gizmo_pair_overflow", "gizmo_tile_overflow")


def twin_2d_phases(dev, n, smi):
    """Phases 31-34: the rest of 2D (text, sprite sheets, tilemaps, 9-slice
    and tiled sprites, gizmos, split-screen) on B4 and B5."""
    import torch_2d_gizmos
    import torch_many_gizmos
    import torch_many_text2d
    import torch_split_screen_2d
    import torch_sprite_sheet
    import torch_text2d
    import torch_tilemap
    from torch_many_cubes import profile
    from torch_scenes import (
        gizmo_world, port_scene_modules, slice_world, text_world,
    )
    from bevy_tpu_torch.render import frame_image

    # -- 31: the small frames, the card against the CPU -------------------
    pm = port_scene_modules()
    small = [
        ("text2d", lambda d: torch_text2d.build_app(device=d), 1, 1 / 60),
        ("sprite_sheet", lambda d: torch_sprite_sheet.build_app(device=d),
         10, 1 / 60),
        ("tilemap (across the tide's tile edit)",
         lambda d: torch_tilemap.build_app(device=d), 5, 0.25),
        ("2d_gizmos", lambda d: torch_2d_gizmos.build_app(device=d), 3,
         1 / 60),
        ("split_screen_2d 640x360 tiles",
         lambda d: torch_split_screen_2d.build_app(640, 360, device=d), 5,
         1 / 60),
        ("split_screen_2d 640x360 splat",
         lambda d: torch_split_screen_2d.build_app(640, 360, mode="splat",
                                                   device=d), 5, 1 / 60),
        ("text_world (digits, rich text)",
         lambda d: text_world(pm, {"device": d}), 12, 1 / 60),
        ("gizmo_world (2D, 3D, retained, stroke text)",
         lambda d: gizmo_world(pm, {"device": d}), 2, 1 / 60),
        ("slice_world (9-slice, tiled)",
         lambda d: slice_world(pm, {"device": d}), 1, 1 / 60),
    ]
    for name, build, frames, dt in small:
        with Recorder() as rec:
            app = build(dev)
            app.run(max_frames=frames, dt=dt)
        torch.cuda.synchronize()
        cpu = build("cpu")
        cpu.run(max_frames=frames, dt=dt)
        img = frame_image(app)
        d = np.abs(img.astype(int) - frame_image(cpu).astype(int)).max(-1)
        frac = float((d > 8).mean())
        log(f"{name} ({frames} frames) on the card vs the CPU: {frac:.4%} "
            f"of pixels drift > 8 (max channel diff {d.max()}, "
            f"{int((d > 0).sum())} pixels differ); drawn pixels "
            f"{frame_drawn(app.world.state):.3f}")
        if frac >= 0.01:
            raise AssertionError(f"{name}: the card's frame differs from "
                                 f"the CPU's")
        calls = check_kernel_calls(name, rec)
        if not calls["B4"] + calls["B5"]:
            raise AssertionError(f"{name} launched no sprite kernel")
        stats = app.world.state["res"]["render_stats"]
        check_stats(app.world.state, [k for k in STATS_2D + GIZMO_STATS
                                      if k in stats])
        del app, cpu, rec

    # -- 32: many_text2d at 1280x720, tiles (B4) and splat (B5) -----------
    labels = torch_many_text2d.n_labels_for(1280, 720)
    for mode, kid in (("tiles", "B4"), ("splat", "B5")):
        app = torch_many_text2d.build_app(mode=mode, device=dev)
        glyphs = app.world.entity_count() - 1
        ms, launches, stats, _ = timed_frames(app, n)
        others = {k: v for k, v in launches.items() if k != kid and v}
        log(f"many_text2d {labels} labels ({glyphs} glyph sprites) "
            f"@1280x720, {mode}: {ms:.3f} ms/frame over {n} frames (CUDA "
            f"events; {smi})")
        log(f"launches in those {n} frames: {kid} {launches[kid]}, others "
            f"{others}; pair_overflow {stats['pair_overflow']}, "
            f"tile_overflow {stats['tile_overflow']}, visible_overflow "
            f"{stats['visible_overflow']}; drawn pixels "
            f"{frame_drawn(app.world.state):.3f}")
        if launches[kid] != n or others:
            raise AssertionError(f"launches on the many_text2d path: "
                                 f"{launches}")
        check_stats(app.world.state, STATS_2D)
        with Recorder() as rec:
            app.update(dt=1 / 60)
        torch.cuda.synchronize()
        check_kernel_calls(f"many_text2d 1280x720 {mode}", rec, (kid,))
        a, kw = rec.calls[kid][-1]
        k_ms, rows = device_ms(lambda: kernel_fn(kid)(*a, **kw))
        b = BOUNDS[kid](a, kw)
        log(f"{kid} in the many_text2d {mode} frame: device {k_ms:.4f} ms a "
            f"call (20 queued behind a spin kernel), bound {b[0]:.4f} ms "
            f"({b[1]})")
        if mode == "tiles":
            profile(app.frame_fn(), app.world.state, 5)
        del app, rec
        torch.cuda.empty_cache()

    # -- 33: many_gizmos at 1280x720: B4 in the sprite and gizmo passes ---
    lines = torch_many_gizmos.n_lines_for(1280, 720)
    app = torch_many_gizmos.build_app(device=dev)
    ms, launches, stats, _ = timed_frames(app, n)
    others = {k: v for k, v in launches.items() if k != "B4" and v}
    log(f"many_gizmos {lines} lines @1280x720: {ms:.3f} ms/frame over {n} "
        f"frames (CUDA events; {smi})")
    log(f"launches in those {n} frames: B4 {launches['B4']} (the sprite "
        f"and the gizmo pass), others {others}; gizmo_pair_overflow "
        f"{stats['gizmo_pair_overflow']}, gizmo_tile_overflow "
        f"{stats['gizmo_tile_overflow']}; drawn pixels "
        f"{frame_drawn(app.world.state):.3f}")
    if launches["B4"] != 2 * n or others:
        raise AssertionError(f"launches on the many_gizmos path: {launches}")
    check_stats(app.world.state, STATS_2D + GIZMO_STATS)
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    if rec.origin["B4"] != ["sprite", "gizmos"]:
        raise AssertionError(f"many_gizmos B4 calls: {rec.origin['B4']}")
    check_kernel_calls("many_gizmos 1280x720", rec, ("B4",))
    a, kw = rec.calls["B4"][1]
    k_ms = cuda_ms(lambda: kernel_fn("B4")(*a, **kw), 20)
    p_ms = cuda_ms(lambda: plain_fn("B4")(*a, **kw), 3)
    d_ms, _ = device_ms(lambda: kernel_fn("B4")(*a, **kw))
    b = BOUNDS["B4"](a, kw)
    log(f"B4 in the many_gizmos gizmo pass ({a[1].shape[0]} buffer rows "
        f"sorted, {int(a[4].sum())} listed (tile, quad) pairs, most in a "
        f"tile {int(a[4].max())}): kernel {k_ms:.4f} ms (CUDA events, 20 "
        f"calls), device {d_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}; {b[2]}), {b[0] / max(d_ms, 1e-9):.1%} of the bound "
        f"by device time")
    profile(app.frame_fn(), app.world.state, 5)
    del app, rec
    torch.cuda.empty_cache()

    # -- 34: split_screen_2d at 1280x720: one call a camera ---------------
    for mode, kid in (("tiles", "B4"), ("splat", "B5")):
        app = torch_split_screen_2d.build_app(mode=mode, device=dev)
        ms, launches, stats, _ = timed_frames(app, n)
        others = {k: v for k, v in launches.items() if k != kid and v}
        log(f"split_screen_2d @1280x720, {mode}: {ms:.3f} ms/frame over "
            f"{n} frames (CUDA events; {smi})")
        log(f"launches in those {n} frames: {kid} {launches[kid]} (2 "
            f"cameras), others {others}; pair_overflow "
            f"{stats['pair_overflow']}, tile_overflow "
            f"{stats['tile_overflow']}, visible_overflow "
            f"{stats['visible_overflow']}; drawn pixels "
            f"{frame_drawn(app.world.state):.3f}")
        if launches[kid] != 2 * n or others:
            raise AssertionError(f"launches on the split-screen path: "
                                 f"{launches}")
        check_stats(app.world.state, STATS_2D)
        with Recorder() as rec:
            app.update(dt=1 / 60)
        torch.cuda.synchronize()
        if check_kernel_calls(f"split_screen_2d 1280x720 {mode}", rec,
                              (kid,))[kid] != 2:
            raise AssertionError("split-screen: not one call a camera")
        if mode == "tiles":
            profile(app.frame_fn(), app.world.state, 5)
        del app, rec
    torch.cuda.synchronize()


# the 3D screen-pass twins at 1280x720: (label, module, build keywords,
# kernels every frame launches)
SCREEN_TWINS = (
    ("post_processing", "torch_post_processing", {}, ("B1",)),
    ("anti_aliasing taa", "torch_anti_aliasing", {"mode": "taa"}, ("B1",)),
    ("anti_aliasing smaa", "torch_anti_aliasing", {"mode": "smaa"},
     ("B1",)),
    ("anti_aliasing ssaa (2560x1440 grid)", "torch_anti_aliasing",
     {"mode": "ssaa"}, ("B1",)),
    ("auto_exposure_demo", "torch_auto_exposure_demo", {}, ("B1",)),
    ("depth_of_field", "torch_depth_of_field", {}, ("B1",)),
    ("motion_blur_demo", "torch_motion_blur_demo", {}, ("B1",)),
    ("fog_3d", "torch_fog_3d", {}, ("B1",)),
    ("fog_3d + shadow maps", "torch_fog_3d", {"shadows": True},
     ("B1", "B3")),
    ("3d_scene skybox", "torch_3d_scene", {}, ("B1",)),
    ("3d_scene atmosphere", "torch_3d_scene", {"atmosphere": True},
     ("B1",)),
    ("pbr_materials", "torch_pbr_materials", {}, ("B1", "B3")),
    ("ssr_demo + contact shadows", "torch_ssr_demo", {"contact": True},
     ("B1", "B3")),
    ("irradiance_volumes", "torch_irradiance_volumes", {}, ("B1", "B3")),
    ("decals", "torch_decals", {}, ("B1", "B3")),
    ("wireframe", "torch_wireframe", {}, ("B1", "B4")),
)
SCREEN_GOLDENS = ("post_f1", "taa_f3", "ssaa2_f1", "fog_f1", "ssr_f1")
STATS_3D = ("pair_overflow", "tile_overflow", "light_pair_overflow",
            "gizmo_pair_overflow", "gizmo_tile_overflow")


def screen_pass_phases(dev, n, smi):
    """Phases 35-36: the 3D frame's screen passes (post-processing, motion
    vectors, SSAA, sky, fog, atmosphere, image-based light, SSR, contact
    shadows, decals, wireframe) on B1, B2, B3 and B4."""
    import importlib

    from torch_many_cubes import profile_frames
    from torch_scenes import (
        GOLDEN_SCENES, golden_key, port_scene_modules,
    )
    from bevy_tpu_torch.render import frame_image

    # -- 35: the small stored frames, the card against the JAX package's
    #    images and the port on the CPU ---------------------------------
    pm = port_scene_modules()
    keys = json.loads((ROOT / "tests" / "goldens" /
                       "torch_goldens.json").read_text())
    for name in SCREEN_GOLDENS:
        if keys.get(name) != golden_key(name):
            raise AssertionError(f"golden {name}: the scene changed")
        fn, args = GOLDEN_SCENES[name]
        with Recorder() as rec:
            img, app = fn(pm, {"device": dev}, {}, *args)
        torch.cuda.synchronize()
        check_golden(img, ROOT / "tests" / "goldens" / f"{name}.png")
        cpu_img, cpu_app = fn(pm, {"device": "cpu"}, {}, *args)
        d = np.abs(img - cpu_img).max(-1)
        log(f"{name} on the card vs the CPU: {float((d > 8).mean()):.4%} "
            f"of pixels drift > 8 (max channel diff {d.max()}, "
            f"{int((d > 0).sum())} pixels differ)")
        if float((d > 8).mean()) >= 0.01:
            raise AssertionError(f"{name}: the card's frame differs from "
                                 f"the CPU's")
        if name == "taa_f3":
            stored = np.load(ROOT / "tests" / "goldens" /
                             "taa_f3_motion.npz")["motion"]
            mo = app.world.state["res"]["render_target"]["motion"].cpu() \
                .numpy()
            both = (mo[2] > 0.5) & (stored[2] > 0.5)
            flip = int(((mo[2] > 0.5) != (stored[2] > 0.5)).sum())
            err = float(np.abs(mo[:2] - stored[:2])[:, both].max())
            log(f"taa_f3 motion planes on the card vs the JAX package's: "
                f"{flip} validity flips, {int(both.sum())} valid in both, "
                f"max |d| {err:.3g} px")
            if flip > 12 or err > 1e-3:
                raise AssertionError("taa_f3 motion planes differ")
        for kid in ("B1", "B2", "B3"):
            calls = rec.calls[kid]
            if not calls:
                continue
            errs = [compare(kid, a, kw) for a, kw in calls]
            worst = max(e[0] for e in errs) if kid == "B3" else max(errs)
            log(f"{kid} vs plain, {name}: {len(calls)} calls "
                f"{'within rtol/atol 1e-5' if kid == 'B3' else 'bit-equal'}"
                f" (max abs err {worst})")
        check_stats(app.world.state, [k for k in STATS_3D if k in
                                      app.world.state["res"]["render_stats"]])
        del app, cpu_app, rec

    # -- 36: each twin at 1280x720 ------------------------------------
    for label, mod_name, kw, kids in SCREEN_TWINS:
        build = importlib.import_module(mod_name).build_app
        app = build(device=dev, **kw)
        ms, launches, stats, covered = timed_frames(app, n)
        ours = {k: v for k, v in launches.items() if v}
        log(f"{label} @1280x720: {ms:.3f} ms/frame over {n} frames (CUDA "
            f"events; {smi}); kernel launches a frame "
            f"{ {k: v / n for k, v in ours.items()} }; overflows "
            f"{ {k: stats[k] for k in STATS_3D if k in stats} }; covered "
            f"pixels {covered:.3f}")
        missing = [k for k in kids if launches[k] == 0]
        if missing or any(launches[k] for k in ("B5", "B6", "B7", "B8")):
            raise AssertionError(f"{label}: launches {launches}")
        check_stats(app.world.state, [k for k in STATS_3D if k in stats])
        if covered < 0.02:
            raise AssertionError(f"{label}: the frame drew (almost) nothing")
        with Recorder() as rec:
            app.update(dt=1 / 60)
        torch.cuda.synchronize()
        for kid in ("B1", "B2", "B3", "B4"):
            calls = rec.calls[kid]
            if not calls:
                continue
            errs = [compare(kid, a, kw_) for a, kw_ in calls]
            worst = max(e[0] for e in errs) if kid == "B3" else max(errs)
            log(f"  {kid} vs plain, {label}: {len(calls)} calls of a frame "
                f"{'within rtol/atol 1e-5' if kid == 'B3' else 'bit-equal'}"
                f" (max abs err {worst})")
        del rec
        state, wall, nk, per_span, _, _ = profile_frames(
            app.frame_fn(), app.world.state, 3)
        app.world.state = state
        busy = sum(per_span.values()) / 1000.0
        top = sorted(per_span.items(), key=lambda kv: -kv[1])[:6]
        log(f"  profile, 3 frames: {wall / 3:.3f} ms/frame wall (profiler "
            f"on), kernels {busy / 3:.3f} ms/frame = {busy / wall:.1%} busy,"
            f" idle {1 - busy / wall:.1%}, {nk // 3} kernel launches/frame; "
            f"device ms/frame by innermost span: "
            + "; ".join(f"{k_} {us / 3000:.3f}" for k_, us in top))
        img = frame_image(app)
        if not np.isfinite(img).all():
            raise AssertionError(f"{label}: image not finite")
        del app
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# the slice's stored small frames (tests/make_torch_goldens.py; phase 37)
A8_GOLDENS = ("split_two", "split_layers", "split_four", "oit_panes",
              "oit_blend", "glass_tint", "glass_volume",
              "glass_translucent", "shader_toon", "shader_quantize",
              "bias_green", "bias_red", "occl_f3", "budget_64", "bvh_f1",
              "lod_15",
              "lod_coarse", "dag_f1", "smooth_srec")
# the OIT, transmission and custom-material twins at 1280x720 (phase 38)
A8_TWINS = (("transparency_3d", "torch_transparency_3d"),
            ("blend_modes", "torch_blend_modes"),
            ("glass_and_coat", "torch_glass_and_coat"),
            ("shader_material", "torch_shader_material"))


def dtoh_count(app):
    """The Memcpy DtoH records of one frame after a warm one
    (torch.profiler's CUDA activity): each is a read of the device by the
    host."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    step = app.frame_fn()
    state = step(app.world.state)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        state = step(state)
        torch.cuda.synchronize()
    app.world.state = state
    return sum(1 for e in prof.events() if "Memcpy DtoH" in e.name)


def check_calls(label, rec, kids=("B1", "B2", "B7")):
    """Every recorded call of `kids` against its plain version, bit for
    bit; logs the counts. Returns {kid: [(a, kw), ...]}."""
    for kid in kids:
        calls = rec.calls[kid]
        if not calls:
            continue
        errs = [compare(kid, a, kw) for a, kw in calls]
        at = {"B1": 6, "B2": 5}.get(kid, 7)      # the scissor argument
        sc = sum(1 for a, kw in calls if len(a) > at and a[at] is not None)
        log(f"  {kid} vs plain, {label}: {len(calls)} calls bit-equal "
            f"({sc} scissored; max abs err {max(errs)})")
    return rec.calls


def a8_phases(dev, n, smi, results):
    """Phases 37-38: the rest of A8 — cameras and viewports (B1's scissor
    instantiation, B2's and B7's), OIT, transmission, custom materials,
    depth bias, two-phase occlusion, the BVH cull, LOD chains and the
    cluster DAG."""
    import importlib

    import torch_many_cubes
    from torch_many_cubes import profile_frames
    from torch_scenes import (
        GOLDEN_SCENES, b1_cull_scenes, bvh_world, dag_world, golden_key,
        occl_world, port_scene_modules, shade_record_world, split_world,
    )
    from bevy_tpu_torch.render import frame_image

    # -- 37a: B1's scissor instantiation on the cull scenes, under a rect
    #    that cuts windows, blocks and tiles on all four sides -----------
    for name, (rows, d0, w0, o, m, v, kw, _) in b1_cull_scenes(dev).items():
        H, W = d0.shape
        sc = torch.tensor([W * 0.15 + 0.5, H * 0.1 + 0.25, W * 0.8 + 0.25,
                           H * 0.85], device=dev)
        a = (d0, w0, rows, o, m, v, sc)
        err = compare("B1", a, kw)
        cut = kernel_fn("B1")(*a, **kw)[1]
        full = kernel_fn("B1")(*a[:6], **kw)[1]
        log(f"B1 vs plain, {name} scene, scissor {sc.tolist()}: bit-equal "
            f"(max abs err {err}); {int((cut != full).sum())} pixels the "
            f"rect keeps from a slot")
        if bool((cut == full).all()):
            raise AssertionError("the B1 scissor rect cut nothing")
        b1_cull_line(f"{name} scene, scissor", a, kw)

    # -- 37b: the split-screen worlds on both routes, and the slice's
    #    stored small frames, against the JAX package's images ------------
    pm = port_scene_modules()
    gold = ROOT / "tests" / "goldens"
    keys = json.loads((gold / "torch_goldens.json").read_text())
    for name in A8_GOLDENS:
        if keys.get(name) != golden_key(name):
            raise AssertionError(f"golden {name}: the scene changed")
        fn, args = GOLDEN_SCENES[name]
        routes = ({}, {"backend": "xla"}) if fn is split_world else ({},)
        for route in routes:
            label = f"{name}{' (general route)' if route else ''}"
            with Recorder() as rec:
                if fn is shade_record_world:
                    img, app = fn(pm, args[0], {"device": dev}, route)
                else:
                    img, app = fn(pm, {"device": dev}, route, *args)
            torch.cuda.synchronize()
            if fn is occl_world:
                stored = np.load(gold / f"{name}.npz")["frames"].astype(int)
                for i, (a_, b_) in enumerate(zip(img, stored)):
                    d = np.abs(a_ - b_).max(-1)
                    log(f"golden {name} frame {i}: {float((d > 8).mean()):.4%}"
                        f" of pixels drift > 8 (max channel diff {d.max()})")
                    if float((d > 8).mean()) >= 0.01:
                        raise AssertionError(f"golden {name} failed")
                vis = app.world.state["res"]["mesh_vis"]["g0v0"]
                log(f"  {name}: occlusion mask {int(vis.sum())} of "
                    f"{vis.numel()} clusters visible after 3 frames")
            else:
                check_golden(img, gold / f"{name}.png")
            check_calls(label, rec)
            stat_keys = [k for k in STATS_3D
                         if k in app.world.state["res"]["render_stats"]]
            if name == "budget_64":     # 64 of the visible clusters drawn
                st = app.world.state["res"]["render_stats"]
                log(f"  {name}: pair_overflow {int(st['pair_overflow'])} "
                    f"(the visible clusters past the budget)")
                stat_keys.remove("pair_overflow")
            check_stats(app.world.state, stat_keys)
            if name == "split_two" and not route:
                log(f"  split_two, one two-camera frame: "
                    f"{dtoh_count(app)} Memcpy DtoH records")
            del app, rec

    # -- 38a: the split-screen twin at 1280x720, four cameras -------------
    import torch_split_screen
    app = torch_split_screen.build_app(device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"split_screen 4 cameras @1280x720: {ms:.3f} ms/frame over {n} "
        f"frames (CUDA events; {smi}); kernel launches a frame "
        f"{ {k: v / n for k, v in launches.items() if v} }; overflows "
        f"{ {k: stats[k] for k in STATS_3D if k in stats} }; covered "
        f"pixels {covered:.3f}")
    if launches["B1"] != 24 * n or launches["B2"] != 12 * n or any(
            launches[k] for k in ("B3", "B4", "B5", "B6", "B7", "B8")):
        raise AssertionError(f"split_screen: launches {launches} (B1 twice "
                             f"and B2 once a camera and mesh group)")
    check_stats(app.world.state, [k for k in STATS_3D if k in stats])
    with Recorder() as rec:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    calls = check_calls("split_screen @1280x720", rec, ("B1", "B2"))
    if not all(a[6] is not None for a, _ in calls["B1"]):
        raise AssertionError("split_screen: a B1 call without its scissor")
    a, kw = max(calls["B1"], key=lambda c: int(c[0][5].sum()))
    b1_cull_line("split_screen @1280x720, busiest scissored call", a, kw)
    sc = time_kernel("B1", a, kw, launches["B1"], compare("B1", a, kw),
                     where="on the split-screen frame's busiest scissored "
                     "call")
    results["B1"]["scissor"] = {k: sc[k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    log(f"  split_screen, one four-camera frame: {dtoh_count(app)} Memcpy "
        f"DtoH records")
    state, wall, nk, per_span, _, _ = profile_frames(
        app.frame_fn(), app.world.state, 3)
    app.world.state = state
    busy = sum(per_span.values()) / 1000.0
    top = sorted(per_span.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile, 3 frames: {wall / 3:.3f} ms/frame wall (profiler on), "
        f"kernels {busy / 3:.3f} ms/frame = {busy / wall:.1%} busy, idle "
        f"{1 - busy / wall:.1%}, {nk // 3} kernel launches/frame; device "
        f"ms/frame by innermost span: "
        + "; ".join(f"{k_} {us / 3000:.3f}" for k_, us in top))
    del app, rec, calls
    torch.cuda.empty_cache()

    # -- 38b: many_cubes 160k with two-phase occlusion culling ------------
    apps = {}
    for occ in (False, True):
        app = torch_many_cubes.build_app(device=dev, occlusion_cull=occ,
                                         phase_budget=160_000)
        ms, launches, stats, covered = timed_frames(app, n)
        log(f"many_cubes 160000 @1280x720, occlusion_cull={occ}: "
            f"{ms:.3f} ms/frame over {n} frames (CUDA events; {smi}); "
            f"launches a frame "
            f"{ {k: v / n for k, v in launches.items() if v} }"
            f"; pair_overflow {stats['pair_overflow']}, tile_overflow "
            f"{stats['tile_overflow']}, fallback clusters "
            f"{stats['fallback_clusters'] / n:.1f}/frame")
        check_stats(app.world.state, ("pair_overflow",))
        apps[occ] = app
    vis = apps[True].world.state["res"]["mesh_vis"]["g0v0"]
    log(f"  occlusion mask after {n + 3} frames: {int(vis.sum())} of "
        f"{vis.numel()} clusters visible")
    d = np.abs(frame_image(apps[True]).astype(int) -
               frame_image(apps[False]).astype(int)).max(-1)
    log(f"  many_cubes occluded vs unculled frame: "
        f"{float((d > 8).mean()):.4%} of pixels drift > 8 (max channel diff "
        f"{d.max()}, {int((d > 0).sum())} pixels differ)")
    if float((d > 8).mean()) >= 0.01:
        raise AssertionError("occlusion culling changed the frame")
    with Recorder() as rec:
        apps[True].update(dt=1 / 60)
    torch.cuda.synchronize()
    check_calls("many_cubes occlusion @1280x720", rec, ("B1", "B2"))
    state, wall, nk, per_span, _, _ = profile_frames(
        apps[True].frame_fn(), apps[True].world.state, 3)
    busy = sum(per_span.values()) / 1000.0
    top = sorted(per_span.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile, 3 occlusion frames: {wall / 3:.3f} ms/frame wall "
        f"(profiler on), kernels {busy / 3:.3f} ms/frame = "
        f"{busy / wall:.1%} busy, {nk // 3} kernel launches/frame; device "
        f"ms/frame by innermost span: "
        + "; ".join(f"{k_} {us / 3000:.3f}" for k_, us in top))
    del apps, rec, state
    torch.cuda.empty_cache()

    # -- 38c: the BVH and cluster-DAG scenes at 1280x720 ------------------
    imgs = {}
    for flag in (False, True):
        with Recorder() as rec:
            imgs[flag], app = bvh_world(pm, {"device": dev}, {}, flag,
                                        width=1280, height=720)
        torch.cuda.synchronize()
        check_calls(f"bvh_world bvh_cull={flag} @1280x720", rec,
                    ("B1", "B2"))
        check_stats(app.world.state, ("pair_overflow", "tile_overflow"))
    same = bool((imgs[True] == imgs[False]).all())
    log(f"  bvh_world @1280x720: the culled frame equals the unculled: "
        f"{same}")
    if not same:
        raise AssertionError("the BVH cull changed the frame")
    # the JAX test's distance (at 1280x720 its cut is the full-detail
    # clusters) and a far one, where the cut mixes levels
    for dist in (6.0, 40.0):
        for flag in (False, True):
            with Recorder() as rec:
                imgs[flag], app = dag_world(pm, {"device": dev}, {}, flag,
                                            dist=dist, width=1280,
                                            height=720)
            torch.cuda.synchronize()
            check_calls(f"dag_world dag={flag} at {dist} @1280x720", rec,
                        ("B1", "B2"))
            check_stats(app.world.state, ("pair_overflow", "tile_overflow"))
        d = np.abs(imgs[True] - imgs[False]).max(-1)
        log(f"  dag_world at {dist} @1280x720, the DAG cut against full "
            f"detail: {float((d > 24).mean()):.4%} of pixels differ by > 24"
            f" (the JAX test's bound: 2%), {float((d > 8).mean()):.4%} by "
            f"> 8, {int((d > 0).sum())} pixels differ")
        if float((d > 24).mean()) >= 0.02:
            raise AssertionError("the DAG cut diverges from full detail")
    del app, rec, imgs

    # -- 38d: the OIT, transmission and custom-material twins -------------
    for label, mod_name in A8_TWINS:
        app = importlib.import_module(mod_name).build_app(device=dev)
        ms, launches, stats, covered = timed_frames(app, n)
        log(f"{label} @1280x720: {ms:.3f} ms/frame over {n} frames (CUDA "
            f"events; {smi}); kernel launches a frame "
            f"{ {k: v / n for k, v in launches.items() if v} }; overflows "
            f"{ {k: stats[k] for k in STATS_3D if k in stats} }; covered "
            f"pixels {covered:.3f}")
        if launches["B1"] == 0 or any(launches[k] for k in (
                "B3", "B4", "B5", "B6", "B7", "B8")):
            raise AssertionError(f"{label}: launches {launches}")
        check_stats(app.world.state, [k for k in STATS_3D if k in stats])
        with Recorder() as rec:
            app.update(dt=1 / 60)
        torch.cuda.synchronize()
        check_calls(label, rec, ("B1", "B2"))
        state, wall, nk, per_span, _, incl = profile_frames(
            app.frame_fn(), app.world.state, 3)
        app.world.state = state
        busy = sum(per_span.values()) / 1000.0
        top = sorted(per_span.items(), key=lambda kv: -kv[1])[:6]
        log(f"  profile, 3 frames: {wall / 3:.3f} ms/frame wall (profiler "
            f"on), kernels {busy / 3:.3f} ms/frame = {busy / wall:.1%} busy,"
            f" idle {1 - busy / wall:.1%}, {nk // 3} kernel launches/frame; "
            f"device ms/frame by innermost span: "
            + "; ".join(f"{k_} {us / 3000:.3f}" for k_, us in top)
            + "".join(f"; {k_} with every kernel inside {us / 3000:.3f}"
                      for k_, (_, us) in incl.items()))
        if not np.isfinite(frame_image(app)).all():
            raise AssertionError(f"{label}: image not finite")
        del app, rec
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


ECS_TWINS = ("run_conditions", "change_detection", "removal_detection",
             "component_hooks", "observer_propagation", "one_shot_systems",
             "states", "sub_states", "computed_states", "system_stepping",
             "ecs_hierarchy", "many_components", "message_events",
             "startup_systems")
# the twins whose frames run on the device alone: 0 Memcpy DtoH a frame
DEVICE_TIER_TWINS = ("run_conditions", "states", "computed_states",
                     "change_detection", "observer_propagation")
ALIEN_FRAMES = 240      # the JAX example's session: the first cake is
                        # eaten near frame 215 (PERF.md, ROADMAP C3)


def sys_by_name(state):
    """A world state with its systems ('name#counter' ids, numbered per
    process) keyed by name and their order among systems of that name."""
    groups = {}
    for sid in sorted(state["sys"], key=lambda x: int(x.rsplit("#", 1)[1])):
        groups.setdefault(sid.rsplit("#", 1)[0], []).append(state["sys"][sid])
    return dict(state, sys={f"{name}/{k}": st for name, sts in groups.items()
                            for k, st in enumerate(sts)})


def same_port_state(a, b, path=()):
    """Two port world states (nested dicts of tensors on any devices):
    the same keys, ints and bools equal, floats within 1e-5."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                set(a) != set(b):
            raise AssertionError(f"state {path}: keys differ")
        for k in a:
            same_port_state(a[k], b[k], path + (k,))
        return
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"state {path}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    ok = torch.allclose(a, b, rtol=1e-5, atol=1e-5) if a.is_floating_point() \
        else torch.equal(a, b)
    if not ok:
        raise AssertionError(f"state {path}: card and CPU differ")


def update_profile(step, state, frames=20):
    """Kernel launches and Memcpy DtoH records a frame over `frames` frames
    of `step` (torch.profiler's CUDA activity). Raises when the profiler
    kept no kernel record: a window of a few small kernels can come back
    empty (one frame of ~10 kernels did, on the H100), and then it could
    not have seen a host read either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch_many_cubes import SPANS
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            state = step(state)
        torch.cuda.synchronize()
    events = prof.events()
    dtoh = sum(1 for e in events if "Memcpy DtoH" in e.name)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(SPANS + ("Memcpy", "Memset")))
    if kernels == 0:
        raise AssertionError(f"the profiler kept no kernel record over "
                             f"{frames} frames")
    return kernels / frames, dtoh / frames


def a7_phases(dev, smi, results):
    """Phase 39: the ECS and app core (A7a) — the ECS twins on the card
    against the CPU, and alien_cake_addict at 1280x720."""
    import importlib

    import torch_alien_cake_addict as alien
    from torch_ecs_run import drive, update_step
    from torch_many_cubes import profile_frames
    from bevy_tpu_torch.render import frame_image

    # -- 39a: the ECS twins, card against CPU -----------------------------
    for name in ECS_TWINS:
        mod = importlib.import_module(f"torch_{name}")
        cpu = drive(mod, mod.build_app(device="cpu"), 5)
        card = drive(mod, mod.build_app(device=dev), 5)
        torch.cuda.synchronize()
        same_port_state(sys_by_name(card.world.state),
                        sys_by_name(cpu.world.state))
        launches, dtoh = update_profile(update_step(mod, card),
                                        card.world.state)
        log(f"twin {name}: 5 frames, the card's world state equals the "
            f"CPU's; 20 more frames: {launches:.1f} kernel launches and "
            f"{dtoh:.2f} Memcpy DtoH records a frame")
        if name in DEVICE_TIER_TWINS and dtoh:
            raise AssertionError(f"twin {name}: {dtoh} host reads a frame")
        del cpu, card

    # -- 39b: alien_cake_addict at 1280x720 -------------------------------
    t0 = time.perf_counter()
    cpu_rows = alien.play(alien.build_app(width=128, height=80,
                                          device="cpu"), ALIEN_FRAMES)
    log(f"alien_cake_addict on the CPU at 128x80: {ALIEN_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s, score {cpu_rows[-1][4]}")
    app = alien.build_app(device=dev)
    rows, n_b1, n_b2, errs = [], 0, 0, []
    t0 = time.perf_counter()
    for chunk in range(0, ALIEN_FRAMES, 20):
        with Recorder() as rec:
            rows += alien.play(app, min(20, ALIEN_FRAMES - chunk))
        torch.cuda.synchronize()
        for kid in ("B1", "B2"):
            for a, kw in rec.calls[kid]:
                errs.append(compare(kid, a, kw))
        n_b1 += len(rec.calls["B1"])
        n_b2 += len(rec.calls["B2"])
        del rec
    check_stats(app.world.state, ("pair_overflow",))
    stats = {k: int(v) for k, v in
             app.world.state["res"]["render_stats"].items()}
    log(f"alien_cake_addict @1280x720, {ALIEN_FRAMES} frames of the chase "
        f"({time.perf_counter() - t0:.1f} s with the checks): score "
        f"{rows[-1][4]}; B1 {n_b1} and B2 {n_b2} calls, each bit-equal to "
        f"plain (max abs err {max(errs)}); render_stats {stats}")
    if rows != cpu_rows:
        first = next(i for i, (x, y) in enumerate(zip(rows, cpu_rows))
                     if x != y)
        raise AssertionError(f"alien_cake_addict: trajectory differs from "
                             f"the CPU's at frame {first}")
    if rows[-1][4] <= 0:
        raise AssertionError("alien_cake_addict: never ate a cake")
    if n_b1 == 0:
        raise AssertionError("alien_cake_addict: B1 never launched")
    # timing: frame by frame, CUDA events around each update
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
           for _ in range(ALIEN_FRAMES)]
    reset_launches()
    for s_, e_ in evs:
        s_.record()
        alien.play(app, 1)
        e_.record()
    torch.cuda.synchronize()
    launches = read_launches()
    ms = np.asarray([s_.elapsed_time(e_) for s_, e_ in evs])
    log(f"alien_cake_addict @1280x720 ({smi}): {ALIEN_FRAMES} more frames, "
        f"ms/frame median {np.median(ms):.3f} (min {ms.min():.3f}, p10 "
        f"{np.percentile(ms, 10):.3f}, p90 {np.percentile(ms, 90):.3f}, max "
        f"{ms.max():.3f}); kernel launches a frame "
        f"{ {k: v / ALIEN_FRAMES for k, v in launches.items() if v} }; "
        f"pair_overflow {int(app.world.state['res']['render_stats']['pair_overflow'])}")
    if launches["B1"] == 0 or any(launches[k] for k in (
            "B3", "B4", "B5", "B6", "B7", "B8")):
        raise AssertionError(f"alien_cake_addict: launches {launches}")
    check_stats(app.world.state, ("pair_overflow",))

    def step(state):
        app.world.state = state
        alien.play(app, 1)
        return app.world.state

    nk, dtoh = update_profile(step, app.world.state, frames=3)
    state, wall, nk3, per_span, _, _ = profile_frames(step, app.world.state,
                                                      3)
    busy = sum(per_span.values()) / 1000.0
    top = sorted(per_span.items(), key=lambda kv: -kv[1])[:6]
    log(f"  alien_cake_addict, 3 frames: {nk:.1f} kernel launches and "
        f"{dtoh:.1f} Memcpy DtoH records a frame; profile, 3 frames: {wall / 3:.3f} ms/frame "
        f"wall (profiler on), kernels {busy / 3:.3f} ms/frame = "
        f"{busy / wall:.1%} busy, {nk3 // 3} kernel launches/frame; device "
        f"ms/frame by innermost span: "
        + "; ".join(f"{k_} {us / 3000:.3f}" for k_, us in top))
    img = frame_image(app)
    if not np.isfinite(img).all() or img.std() == 0:
        raise AssertionError("alien_cake_addict: frame not drawn")
    for kid, n in (("B1", n_b1), ("B2", n_b2)):
        results.setdefault(kid, {})["alien_cake_addict"] = {
            "launches": launches[kid], "checked_calls": n,
            "max_abs_err": max(errs)}
    del app
    torch.cuda.empty_cache()


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false "
                         "— this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    sys.path.insert(0, str(ROOT / "tests"))     # torch_scenes
    import torch_many_cubes
    import torch_many_lights
    from bevy_tpu_torch.ops import _cuda
    from bevy_tpu_torch.render import frame_image

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("nvcc:", next(ln for ln in nvcc.splitlines() if "release" in ln))
    log("card:", smi)

    # -- build --------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda._Loaded.build_seconds} s, dir {_cuda.build_dir()})")
    entry = None
    regs, spilled = {}, []
    for ln in _cuda._Loaded.ptxas_log.splitlines():
        if "Compiling entry" in ln or "Function properties for" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        kind = None if entry is None else next(
            (k for k in ("splat_windows", "merge_windows", "decode_keys",
                         "init_keys", "stream_tiles", "sprite_tiles",
                         "sprite_splat", "tri_corners", "tri_planes",
                         "shade") if k in entry), entry)
        if "registers" in ln and kind is not None:
            regs.setdefault(kind, []).append(
                int(ln.split("Used ")[1].split()[0]))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and int(m.group(1)) > 0:
            spilled.append(f"{entry} ({m.group(1)} bytes)")
    for kind, r in regs.items():
        log(f"  ptxas: {kind}: {len(r)} entries, {min(r)}-{max(r)} "
            f"registers")
    log(f"  ptxas: {len(spilled)} functions spill"
        + "".join(f"\n    {e}" for e in spilled))

    if sys.argv[1:] == ["--a7-only"]:
        # development: the build and phase 39 alone, no result line
        a7_phases(dev, smi, {"B1": {}, "B2": {}})
        log(f"chip_smoke.py --a7-only ran {time.perf_counter() - t_start:.1f}"
            f" s")
        return

    if sys.argv[1:] == ["--a8-only"]:
        # development: the build and phases 37-38 alone, no result line
        a8_phases(dev, 10, smi, {"B1": {}})
        log(f"chip_smoke.py --a8-only ran {time.perf_counter() - t_start:.1f}"
            f" s")
        return

    # -- kernels vs plain, golden scene and near-plane scene ------------
    golden_app = torch_many_cubes.build_app(
        n_cubes=300, width=320, height=180, capacity=512,
        window_budget=4096, device=dev)
    with Recorder() as rec_golden:
        golden_app.run(max_frames=2, dt=1 / 60)
    near_app = near_plane_app(dev)
    with Recorder() as rec_near:
        near_app.run(max_frames=1, dt=1 / 60)
    torch.cuda.synchronize()
    b2_lists = sum(int(a[4].sum()) for a, _ in rec_near.calls["B2"])
    if b2_lists == 0:
        raise AssertionError("near-plane scene gave B2 no cluster to draw")
    for name, recd in (("golden", rec_golden), ("near-plane", rec_near)):
        for kid in ("B1", "B2"):
            errs = [compare(kid, a, kw) for a, kw in recd.calls[kid]]
            log(f"{kid} vs plain, {name} scene: {len(errs)} calls bit-equal "
                f"(max abs err {max(errs)})")
        for a, kw in recd.calls["B1"]:
            b1_cull_line(f"{name} scene", a, kw)
        for a, kw in recd.calls["B2"]:
            b2_cull_line(f"{name} scene", a, kw)
    log(f"near-plane scene: {b2_lists} (tile, cluster) entries through B2")
    # B2's scissor instantiation, with a rect that cuts tiles and blocks
    for a, kw in rec_near.calls["B2"]:
        H, W = a[0].shape
        sc = (W * 0.15 + 0.5, H * 0.1 + 0.25, W * 0.8 + 0.25, H * 0.85)
        err = compare("B2", a[:5] + (sc,), kw)
        cut = kernel_fn("B2")(*a[:5], sc, **kw)[1]
        full = kernel_fn("B2")(*a[:5], **kw)[1]
        log(f"B2 vs plain, near-plane scene, scissor {sc}: bit-equal (max "
            f"abs err {err}); {int((cut != full).sum())} pixels the rect "
            f"keeps from a triangle")
        if bool((cut == full).all()):
            raise AssertionError("the B2 scissor rect cut nothing")
    from torch_scenes import b1_cull_scenes
    for name, (rows, d0, w0, o, m, v, kw, _) in b1_cull_scenes(dev).items():
        a = (d0, w0, rows, o, m, v)
        err = compare("B1", a, kw)
        log(f"B1 vs plain, {name} scene: bit-equal (max abs err {err})")
        b1_cull_line(f"{name} scene", a, kw)
    from torch_scenes import b2_scenes
    for name, (a, kw) in b2_scenes(dev).items():
        H, W = a[0].shape
        for sc in (None, (W * 0.2 + 0.5, H * 0.15, W * 0.75 + 0.25,
                          H * 0.9 + 0.5)):
            err = compare("B2", a + (sc,), kw)
            log(f"B2 vs plain, {name} scene, scissor {sc}: bit-equal (max "
                f"abs err {err})")
        b2_cull_line(f"{name} scene", a, kw)
    torch.cuda.synchronize()

    # -- golden image --------------------------------------------------
    check_golden(frame_image(golden_app), GOLDEN)
    torch.cuda.synchronize()

    # -- full size: 160k cubes at 1280x720 -----------------------------
    n = 20
    app = torch_many_cubes.build_app(device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_cubes 160000 @1280x720: {ms:.3f} ms/frame over {n} frames "
        f"(CUDA events; {smi})")
    log(f"launches in those {n} frames: B1 {launches['B1']}, "
        f"B2 {launches['B2']}; fallback clusters to B2 "
        f"{stats['fallback_clusters'] / n:.1f}/frame; pair_overflow "
        f"{stats['pair_overflow']}, tile_overflow {stats['tile_overflow']}; "
        f"covered pixels {covered:.3f}")
    if launches["B1"] == 0 or launches["B2"] == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if stats["fallback_clusters"] == 0:
        raise AssertionError("no fallback cluster reached B2 at full size")
    if covered < 0.05:
        raise AssertionError("full-size frame drew (almost) nothing")

    # -- per kernel at the full-size shapes: parity + time ---------------
    from bevy_tpu_torch.render import mesh3d
    boxes, build_windows = [], mesh3d.build_windows

    def keep_box(aabb, *args, **kw_):
        boxes.append(aabb)
        return build_windows(aabb, *args, **kw_)

    mesh3d.build_windows = keep_box
    try:
        with Recorder() as rec_full:
            app.update(dt=1 / 60)
    finally:
        mesh3d.build_windows = build_windows
    torch.cuda.synchronize()
    results = {}
    # B1: both window classes bit-equal, with their cull counts and the
    # share of window pixels in the owner's screen box; the kernels line
    # carries the full-height class (the last call)
    for (a, kw), box in zip(rec_full.calls["B1"], boxes):
        err = compare("B1", a, kw)
        log(f"B1 vs plain, many_cubes full size, win_h {kw['win_h']}: "
            f"bit-equal (max abs err {err})")
        b1_cull_line("many_cubes full size", a, kw, aabb=box)
        results["B1"] = time_kernel("B1", a, kw, launches["B1"], err)
    a, kw = rec_full.calls["B2"][-1]
    b2_cull_line("many_cubes full size", a, kw)
    results["B2"] = time_kernel("B2", a, kw, launches["B2"],
                                compare("B2", a, kw))
    cubes_img = frame_image(app)
    # the pixels B2 drew in that frame: the fallback clusters' footprint
    a, kw = rec_full.calls["B2"][-1]
    b2_px = (kernel_fn("B2")(*a, **kw)[0] != a[0]).cpu().numpy()
    del app, rec_full, golden_app, near_app, rec_golden, rec_near
    torch.cuda.empty_cache()

    # -- the sharded many_cubes frame and B6 ------------------------------
    sharded_cubes_phases(dev, n, smi, results, cubes_img, b2_px)

    # -- many_lights golden scene: B1, B2, B3 vs plain + image -----------
    lapp = torch_many_lights.build_app(device=dev, **LIGHTS_GOLDEN_KW)
    with Recorder() as rec_lg:
        lapp.update(dt=1 / 60)
    torch.cuda.synchronize()
    for kid in ("B1", "B2", "B3"):
        errs = [compare(kid, a, kw) for a, kw in rec_lg.calls[kid]]
        if not errs:
            raise AssertionError(f"the lights golden scene never called {kid}")
        if kid == "B3":
            log(f"B3 vs plain, lights golden scene: {len(errs)} calls within "
                f"rtol/atol 1e-5 (max abs err {max(e[0] for e in errs)}, max "
                f"rel err {max(e[1] for e in errs)}, "
                f"{sum(e[2] for e in errs)} values differ)")
            for a, kw in rec_lg.calls[kid]:
                b3_cull_line("lights golden scene", a, kw)
        else:
            log(f"{kid} vs plain, lights golden scene: {len(errs)} calls "
                f"bit-equal (max abs err {max(errs)})")
    for a, kw in rec_lg.calls["B1"]:
        b1_cull_line("lights golden scene", a, kw)
    for a, kw in rec_lg.calls["B2"]:
        b2_cull_line("lights golden scene", a, kw)
    lights_img = frame_image(lapp)
    check_golden(lights_img, LIGHTS_GOLDEN)
    check_stats(lapp.world.state, ("light_pair_overflow",
                                   "light_tile_overflow"))

    # -- variants scene: spot, rect, clearcoat, reflectance --------------
    vapp = variants_app(dev)
    with Recorder() as rec_v:
        vapp.update(dt=1 / 60)
    torch.cuda.synchronize()
    for a, kw in rec_v.calls["B3"]:
        on = [k for k in ("spot", "rect", "clearcoat", "reflectance")
              if kw.get(k)]
        if len(on) != 4:
            raise AssertionError(f"variants scene shaded with only {on}")
        # and the culled instantiation of the same flags without rect
        for kw_ in (kw, dict(kw, rect=False)):
            on_ = [k for k in on if kw_.get(k)]
            err = compare("B3", a, kw_)
            log(f"B3 vs plain, variants scene ({'+'.join(on_)}, F="
                f"{a[2].shape[1]}): within rtol/atol 1e-5 (max abs err "
                f"{err[0]}, max rel err {err[1]}, {err[2]} values differ)")
            b3_cull_line(f"variants scene ({'+'.join(on_)})", a, kw_)
    del lapp, vapp, rec_lg, rec_v

    # -- many_lights at full size: 100k lights, 1280x720 ----------------
    app = torch_many_lights.build_app(device=dev)
    ms, launches, stats, covered = timed_frames(app, n)
    log(f"many_lights 100000 @1280x720: {ms:.3f} ms/frame over {n} frames "
        f"(CUDA events; {smi})")
    log(f"launches in those {n} frames: B1 {launches['B1']}, B2 "
        f"{launches['B2']}, B3 {launches['B3']}; light_pair_overflow "
        f"{stats['light_pair_overflow']}, light_tile_overflow "
        f"{stats['light_tile_overflow']} ({stats['light_tile_overflow'] / n}"
        f"/frame); fallback clusters to B2 {stats['fallback_clusters'] / n}"
        f"/frame; covered pixels {covered:.3f}")
    if min(launches[k] for k in ("B1", "B2", "B3")) == 0 or \
            launches["B3"] != n:
        raise AssertionError(f"launches on the many_lights path: {launches}")
    if stats["light_pair_overflow"] != 0:
        raise AssertionError("light pairs overflowed their cap at full size")
    # the shared tile_overflow counter also takes the lights' share
    mesh_tile_overflow = stats["tile_overflow"] - stats["light_tile_overflow"]
    if mesh_tile_overflow != 0:
        raise AssertionError(f"the mesh pass's tile lists overflowed: "
                             f"{mesh_tile_overflow}")
    if covered < 0.5:
        raise AssertionError("full-size many_lights frame drew too little")
    with Recorder() as rec_full:
        app.update(dt=1 / 60)
    torch.cuda.synchronize()
    for kid in ("B1", "B2"):
        errs = [compare(kid, a, kw) for a, kw in rec_full.calls[kid]]
        log(f"{kid} vs plain, many_lights full size: {len(errs)} calls "
            f"bit-equal (max abs err {max(errs)})")
    for a, kw in rec_full.calls["B1"]:
        b1_cull_line("many_lights full size", a, kw)
    for a, kw in rec_full.calls["B2"]:
        b2_cull_line("many_lights full size", a, kw)
    a, kw = rec_full.calls["B3"][-1]
    err = compare("B3", a, kw)
    log(f"B3 at full size: max abs err {err[0]}, max rel err {err[1]}, "
        f"{err[2]} values differ "
        f"(F={a[2].shape[1]}, mpt={a[2].shape[2]}, lights listed "
        f"{int(a[3].sum())})")
    results["B3"] = time_kernel("B3", a, kw, launches["B3"], err[0])
    torch.cuda.synchronize()
    lights_full_img = frame_image(app)
    del app, rec_full
    torch.cuda.empty_cache()

    # -- the many_lights frame with a row-band shade ----------------------
    sharded_lights_phases(dev, n, smi, lights_img, lights_full_img)

    sprite_phases(dev, n, smi, results)

    tri_phases(dev, n, smi, results)

    fox_phases(dev, n, smi)

    shadow_phases(dev, n, smi)

    twin_2d_phases(dev, n, smi)

    screen_pass_phases(dev, 10, smi)

    a8_phases(dev, 10, smi, results)

    a7_phases(dev, smi, results)

    log(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
