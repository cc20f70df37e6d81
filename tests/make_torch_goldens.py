"""Renders the JAX package's images that tests/test_torch_shadow.py holds
bevy_tpu_torch against, into tests/goldens/:

- shadow_dir_c2.png, shadow_spot.png, shadow_point.png: the directional
  (2 cascades), spot and point shadow worlds (tests/torch_scenes.py
  shadow_world, the scenes of tests/test_shadow.py, test_spot_shadow.py
  and test_point_shadow.py at 160x96);
- tint_red.npz, aniso_09.npz: the linear colour (H, W, 4) of the
  red-tinted dielectric sphere of tests/test_specular_tint.py and of the
  anisotropic metal sphere (strength 0.9) of tests/test_anisotropy.py
  (material_world); linear, since the sRGB image of the tinted sphere
  clips its highlight and barely changes with the tint;
- shadow_caster_depth.npz: one depth-only raster_batched pass of the
  fixed caster set torch_scenes.caster_pass at 512x512;
- post_f1.png, taa_f3.png (+ taa_f3_motion.npz, the target's motion
  planes after the third frame), ssaa2_f1.png, fog_f1.png, ssr_f1.png:
  the screen-pass worlds of tests/test_torch_motion_ssaa.py
  (torch_scenes post_world, aa_world "taa" and "ssaa", fog_world,
  ssr_world);
- smooth_srec.png: tests/torch_scenes.py shade_record_world "smooth"
  (smooth spheres on the shade records beside flat cubes) through the
  group route's kernels;
- split_two.png, split_layers.png, split_four.png (split_world, through
  the JAX general route: its group route renders no viewport),
  oit_panes.png, oit_blend.png (oit_world), glass_tint.png,
  glass_volume.png, glass_translucent.png (glass_world), shader_toon.png,
  shader_quantize.png (shader_world), bias_green.png, bias_red.png
  (bias_world), occl_f3.npz (occl_world's three frames with occlusion
  culling), budget_64.png (budget_world: 64 of the visible clusters),
  bvh_f1.png, lod_15.png, lod_coarse.png, dag_f1.png: the
  worlds of cameras and viewports, OIT, transmission, custom materials,
  depth bias, occlusion, the BVH cull, LOD chains and the cluster DAG;
- ecs_one_shot_systems.npz, ecs_computed_states.npz,
  ecs_message_events.npz, ecs_startup_systems.npz: the JAX examples'
  whole world states after each of five frames of their twins' scripts
  (tests/torch_ecs_parity.py run_jax; these four JAX examples fail in
  whole JAX test runs);
- alien_trajectory.npz: the JAX alien_cake_addict's game trajectory over
  240 frames of the scripted chase (player cell, cake cell, score a
  frame), alien_f190.png and alien_f190_xla.png: its 128x80 frame after
  190 of them, in pallas_interpret and on the general route
  (backend="xla") (torch_scenes.alien_world);
- torch_goldens.json: each image's torch_scenes.golden_key (a hash of
  its scene builder and arguments), which the test asserts.

Every JAX plugin runs with backend="pallas_interpret" (its Pallas kernels
in interpret mode, never the XLA raster "auto" takes on a CPU). Each
world takes one to three minutes of interpret-mode compiling on a CPU,
which is why the tests read stored images instead of rendering them.

    python tests/make_torch_goldens.py              # all
    python tests/make_torch_goldens.py shadow_spot  # some
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "examples"))

import torch_scenes  # noqa: E402

GOLDENS = HERE / "goldens"
JAX_KW = {"backend": "pallas_interpret"}


def jax_modules():
    return {k: importlib.import_module(f"bevy_tpu{v}")
            for k, v in torch_scenes.SCENE_MODULES.items()}


def caster_depth():
    """JAX raster_batched(depth_only=True) of caster_pass, (S, S)."""
    import jax.numpy as jnp
    from bevy_tpu.render.mesh import cuboid
    from bevy_tpu.render.mesh3d import raster_batched

    size = torch_scenes.CASTER_MAP
    clip = jnp.asarray(torch_scenes.caster_pass())
    ni, vc = clip.shape[:2]
    t = SimpleNamespace(color=jnp.zeros((4, size, size), jnp.float32),
                        depth=jnp.zeros((size, size), jnp.float32))
    st = SimpleNamespace(pair_overflow=jnp.zeros((), jnp.int32),
                         tile_overflow=jnp.zeros((), jnp.int32))
    raster_batched(clip, jnp.zeros((ni, vc, 3), jnp.float32),
                   cuboid(1.0, 1.0, 1.0).triangles, jnp.ones(ni, bool),
                   jnp.ones((ni, 4), jnp.float32),
                   jnp.zeros((ni, 3), jnp.float32),
                   jnp.zeros(16, jnp.float32), t, st, depth_only=True,
                   width=size, height=size, tile_h=16, tile_w=128,
                   interpret=True)
    if int(st.pair_overflow) or int(st.tile_overflow):
        raise AssertionError("the caster pass overflowed")
    return np.asarray(t.depth)


def render(name):
    if name.startswith("ecs_"):
        import torch_ecs_parity
        states, _ = torch_ecs_parity.run_jax(name[4:])
        torch_ecs_parity.save_states(name[4:], states)
        return
    m = jax_modules()
    fn, args = torch_scenes.GOLDEN_SCENES[name]
    if name == "shadow_caster_depth":
        np.savez_compressed(GOLDENS / f"{name}.npz", depth=caster_depth())
    elif name == "taa_f3":
        img, app = fn(m, {}, JAX_KW, *args)
        from PIL import Image
        Image.fromarray(img.astype(np.uint8)).save(GOLDENS / f"{name}.png")
        motion = app.world.state["res"]["render_target"]["motion"]
        np.savez_compressed(GOLDENS / f"{name}_motion.npz",
                            motion=np.asarray(motion, np.float32))
    elif fn in (torch_scenes.post_world, torch_scenes.aa_world,
                torch_scenes.fog_world, torch_scenes.ssr_world):
        img = fn(m, {}, JAX_KW, *args)[0]
        from PIL import Image
        Image.fromarray(img.astype(np.uint8)).save(GOLDENS / f"{name}.png")
    elif fn in torch_scenes.A8_BUILDERS:
        import bevy_tpu.render.mesh3d as jm3
        # the JAX transparent phase reads an undefined module name
        # `cl_extra` (ROADMAP C3); None is what its opaque phase passes
        # without a BVH or DAG
        jm3.cl_extra = None
        kw = {"backend": torch_scenes.GOLDEN_BACKEND.get(
            name, JAX_KW["backend"])}
        out = fn(m, {}, kw, *args)[0]
        if fn is torch_scenes.occl_world:
            np.savez_compressed(GOLDENS / f"{name}.npz",
                                frames=np.stack(out).astype(np.uint8))
        else:
            from PIL import Image
            Image.fromarray(out.astype(np.uint8)).save(
                GOLDENS / f"{name}.png")
    elif fn is torch_scenes.alien_world:
        import alien_cake_addict
        img, rows = fn(alien_cake_addict, {}, *args)
        if name == "alien_trajectory":
            np.savez_compressed(GOLDENS / f"{name}.npz",
                                rows=np.asarray(rows, np.int32))
        else:
            from PIL import Image
            Image.fromarray(img.astype(np.uint8)).save(
                GOLDENS / f"{name}.png")
    elif fn is torch_scenes.material_world:
        color = fn(m, args[0], {}, JAX_KW, *args[1:])[1]
        np.savez_compressed(GOLDENS / f"{name}.npz",
                            color=color.astype(np.float32))
    else:
        img = fn(m, args[0], {}, JAX_KW, *args[1:])[0]
        from PIL import Image
        Image.fromarray(img.astype(np.uint8)).save(GOLDENS / f"{name}.png")
    keys_path = GOLDENS / "torch_goldens.json"
    keys = json.loads(keys_path.read_text()) if keys_path.exists() else {}
    keys[name] = torch_scenes.golden_key(name)
    keys_path.write_text(json.dumps(keys, indent=1, sort_keys=True) + "\n")


ECS_STORED = ("one_shot_systems", "computed_states", "message_events",
              "startup_systems")
NAMES = tuple(torch_scenes.GOLDEN_SCENES) + tuple(
    f"ecs_{n}" for n in ECS_STORED)

if __name__ == "__main__":
    for n in sys.argv[1:] or NAMES:
        if n not in NAMES:
            raise SystemExit(f"unknown golden {n!r}: one of {NAMES}")
        render(n)
        print("wrote", n)
