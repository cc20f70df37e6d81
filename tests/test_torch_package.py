"""bevy_tpu_torch as a package: it never imports JAX, importing it builds
nothing, and on CPU tensors each kernel wrapper runs its plain PyTorch
version without launching (or building) a kernel. The one test that
needs a CUDA card carries the `cuda` marker and skips without one; it
runs on the card with `python -m pytest --noconftest
tests/test_torch_package.py -m cuda` (tests/conftest.py imports JAX,
which the card's machine lacks)."""

import ast
import importlib
import pkgutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bevy_tpu_torch
from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops import raster2d, raster2d_splat
from bevy_tpu_torch.ops import raster3d_tris as tris
from bevy_tpu_torch.ops import raster3d_splat as splat
from bevy_tpu_torch.ops import raster3d_visbuf as vis
from bevy_tpu_torch.ops import shade

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bevy_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_scenes.py"]
TWINS = ("torch_many_cubes", "torch_many_lights", "torch_many_sprites",
         "torch_bevymark", "torch_breakout", "torch_3d_shapes",
         "torch_many_foxes", "torch_shadow_showcase", "torch_text2d",
         "torch_many_text2d", "torch_sprite_sheet", "torch_tilemap",
         "torch_2d_gizmos", "torch_many_gizmos", "torch_split_screen_2d",
         "torch_post_processing", "torch_anti_aliasing",
         "torch_auto_exposure_demo", "torch_depth_of_field",
         "torch_motion_blur_demo", "torch_fog_3d", "torch_3d_scene",
         "torch_pbr_materials", "torch_ssr_demo",
         "torch_irradiance_volumes", "torch_decals", "torch_wireframe",
         "torch_split_screen", "torch_transparency_3d", "torch_blend_modes",
         "torch_glass_and_coat", "torch_shader_material")
# the ECS and app twins (no frame size)
ECS_TWINS = ("torch_run_conditions", "torch_change_detection",
             "torch_removal_detection", "torch_component_hooks",
             "torch_observer_propagation", "torch_one_shot_systems",
             "torch_states", "torch_sub_states", "torch_computed_states",
             "torch_system_stepping", "torch_ecs_hierarchy",
             "torch_many_components", "torch_message_events",
             "torch_startup_systems")
TWINS = TWINS + ECS_TWINS + ("torch_alien_cake_addict",)
# the slice modules whose entry points must default to the card
CARD_DEFAULTS = ("torch_split_screen", "torch_transparency_3d",
                 "torch_blend_modes", "torch_glass_and_coat",
                 "torch_shader_material", "torch_many_cubes",
                 "torch_alien_cake_addict") + ECS_TWINS


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_never_imports_jax(path):
    """Parsed, not imported: JAX is preloaded in some environments, so
    sys.modules cannot tell. Nor PIL or fontTools: the card's machine has
    neither."""
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "bevy_tpu", "PIL",
                                  "fontTools")]
    assert not bad, f"{path.name} imports {bad}"


def test_every_example_twin_is_guarded():
    names = {p.stem for p in PORT_FILES}
    assert set(TWINS) <= names


@pytest.mark.parametrize("name", CARD_DEFAULTS)
def test_twin_defaults_to_the_card(name):
    """A twin's build_app runs on the card unless the caller asks for the
    CPU; on a machine without one it raises instead of falling back."""
    import inspect
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        build = importlib.import_module(name).build_app
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert inspect.signature(build).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        kw = {} if name in ECS_TWINS else dict(width=64, height=32)
        if name == "torch_many_cubes":
            kw["n_cubes"] = 8
        with pytest.raises(RuntimeError, match="CUDA"):
            build(**kw)


def test_import_builds_nothing():
    for mod in pkgutil.walk_packages(bevy_tpu_torch.__path__,
                                     "bevy_tpu_torch."):
        importlib.import_module(mod.name)
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        for name in TWINS:
            importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert _cuda._Loaded.lib is None
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _windows_case(device="cpu"):
    """Three windows over a framebuffer that already holds some depth:
    window 2 overlaps window 0 at equal depth, so the first writer must
    keep the pixel; the incoming depth 0.6 beats every write (z = 0.5).
    Returns the inputs and the expected winner ids."""
    rng = np.random.RandomState(0)
    H, W = 40, 200
    rows = np.zeros((2, 1, 128), np.float32)
    # record 0 covers px <= 100 (id 7); record 1 covers everything (id 9)
    rows[0, 0, :13] = [1, 0, -100, 0, 0, -1, 0, 0, -1, 0.0, 0.0, 0.5, 7]
    rows[1, 0, :13] = [0, 0, -1, 0, 0, -1, 0, 0, -1, 0.0, 0.0, 0.5, 9]
    owner = np.array([0, 1, 1], np.int32)
    meta = np.array([0 * 2048 + 0, 1 * 2048 + 8, 0 * 2048 + 0], np.int32)
    wvalid = np.ones(3, bool)
    depth = np.where(rng.uniform(size=(H, W)) < 0.2, 0.6, 0.0).astype(np.float32)
    winner = np.full((H, W), -1.0, np.float32)
    want = np.full((H, W), -1.0, np.float32)
    want[:16, :128] = 9.0
    want[:16, :100] = 7.0
    want[8:24, 128:] = 9.0
    want[depth == 0.6] = -1.0
    return [torch.from_numpy(a).to(device)
            for a in (depth, winner, rows, owner, meta, wvalid)], want


def test_wrappers_take_plain_version_on_cpu():
    splat.fused_eval_composite.launches = 0
    vis.raster_visbuf.launches = 0
    (d0, w0, rows, owner, meta, wvalid), want = _windows_case()
    dep, win = splat.fused_eval_composite(d0, w0, rows, owner, meta, wvalid,
                                          win_h=16, ntri=1, nedge=3)
    assert np.array_equal(win.numpy(), want)
    assert np.array_equal(dep.numpy(), np.where(want >= 0, 0.5, d0.numpy()))
    # B2: one full-frame triangle record (z = 0.25, id 3) in every tile
    recs = torch.zeros((1, 256))
    recs[0, :17] = torch.tensor([-1, 0, 0, 0, 0, -1, 0, 0, -1,
                                 0, 0, 0.25, 3, 0, 0, 200, 40])
    table = torch.full((4, 128), -1, dtype=torch.int32)
    table[:, 0] = 0
    counts = torch.ones(4, dtype=torch.int32)
    dep2, win2 = vis.raster_visbuf(d0, w0, recs, table, counts, tile_h=32,
                                   tile_w=128, cs=1)
    fresh = d0 == 0.0
    assert torch.equal(win2, torch.where(fresh, 3.0, -1.0))
    assert torch.equal(dep2, torch.where(fresh, 0.25, 0.6))
    assert splat.fused_eval_composite.launches == 0
    assert vis.raster_visbuf.launches == 0
    assert _cuda._Loaded.lib is None


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    (d0, w0, rows, owner, meta, wvalid), want = _windows_case("cuda")
    n0 = splat.fused_eval_composite.launches
    dk, wk = splat.fused_eval_composite(d0, w0, rows, owner, meta, wvalid,
                                        win_h=16, ntri=1, nedge=3)
    dp, wp = splat._fused_plain(d0, w0, rows, owner, meta, wvalid, win_h=16,
                                ntri=1, nedge=3)
    torch.cuda.synchronize()
    assert torch.equal(dk, dp) and torch.equal(wk, wp)
    assert np.array_equal(wk.cpu().numpy(), want)
    assert splat.fused_eval_composite.launches == n0 + 1
    with pytest.raises(ValueError):
        splat.fused_eval_composite(d0, w0, rows, owner.long(), meta, wvalid,
                                   win_h=16, ntri=1, nedge=3)
    # B1's cull on slivers, on random planes (zeros, infinities, NaNs) and
    # with 40 slots over 256- and 1200-row windows
    from torch_scenes import b1_cull_scenes
    for rows, d0, w0, owner, meta, wvalid, kw, _ in \
            b1_cull_scenes("cuda").values():
        dk, wk = splat.fused_eval_composite(d0, w0, rows, owner, meta,
                                            wvalid, **kw)
        dp, wp = splat._fused_plain(d0, w0, rows, owner, meta, wvalid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
        assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))


@pytest.mark.cuda
def test_stream_kernel_matches_plain_on_card():
    """B2 on torch_scenes.b2_scenes (slivers; straddlers over tiles of 32 x
    96 in a frame 202 wide, three passes of the list), the scissor off and
    on: bit-equal to the plain version, the inputs unwritten, one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    from torch_scenes import b2_scenes
    for a, kw in b2_scenes("cuda").values():
        h, w = a[0].shape
        before = [x.clone() for x in a]
        for sc in (None, (w * 0.2 + 0.5, h * 0.15, w * 0.75 + 0.25,
                          h * 0.9 + 0.5)):
            n0 = vis.raster_visbuf.launches
            dk, wk = vis.raster_visbuf(*a, sc, **kw)
            dp, wp = vis._raster_visbuf_plain(*a, sc, **kw)
            torch.cuda.synchronize()
            assert vis.raster_visbuf.launches == n0 + 1
            assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
            assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))
        assert all(torch.equal(x, y) for x, y in zip(a, before))


def _composite_case(device="cpu"):
    """B6's scene (chip_smoke.composite_scene: packed windows that overlap
    at unaligned rows, tie with each other and with the incoming depth, and
    run past the frame's right and bottom edges, with an invalid tail), and
    the winners and depths of the TPU kernel's order, window after window
    with a strict `>` (a numpy loop). Returns the inputs on `device`, the
    keywords and the expected (depth, winner)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import COMPOSITE_KW, composite_scene
    t = composite_scene(device)
    depth, winner, windows, owner, meta, wvalid = (x.cpu().numpy()
                                                   for x in t)
    win_h, cs = COMPOSITE_KW["win_h"], COMPOSITE_KW["cs"]
    H, W = depth.shape
    nb = windows.shape[0]
    col, y0 = meta // 2048, meta % 2048
    dep, win = depth.copy(), winner.copy()
    for w in range(nb):
        if not wvalid[w]:
            continue
        for r in range(win_h):
            for lane in range(128):
                y, x = y0[w] + r, col[w] * 128 + lane
                dz = windows[w, r, lane]
                if y < H and x < W and dz > dep[y, x]:
                    dep[y, x] = dz
                    win[y, x] = np.float32(owner[w] * cs +
                                           (dz.view(np.int32) & 15))
    return t, COMPOSITE_KW, (dep, win)


def test_composite_plain_keeps_the_sequential_order():
    splat.composite_windows.launches = 0
    t, kw, (dep, win) = _composite_case()
    dp, wp = splat.composite_windows(*t, **kw)
    assert np.array_equal(dp.numpy().view(np.int32), dep.view(np.int32))
    assert np.array_equal(wp.numpy(), win)
    assert (win >= 0).mean() > 0.2
    assert splat.composite_windows.launches == 0
    assert _cuda._Loaded.lib is None


@pytest.mark.cuda
def test_b6_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    t, kw, (dep, win) = _composite_case("cuda")
    n0 = splat.composite_windows.launches
    dk, wk = splat.composite_windows(*t, **kw)
    dp, wp = splat._composite_plain(*t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    assert torch.equal(wk.view(torch.int32), wp.view(torch.int32))
    assert np.array_equal(wk.cpu().numpy(), win)
    assert splat.composite_windows.launches == n0 + 1
    with pytest.raises(ValueError):
        splat.composite_windows(*t[:3], t[3].long(), *t[4:], **kw)


def _shade_case(device, nf=24, nplanes=22, seed=0):
    """A small deferred-shade input (4 bin tiles of 32 x 128, a sky tile,
    up to 20 lights a tile) made on `device` from a seed."""
    g = torch.Generator().manual_seed(seed)
    H, W = 64, 256

    def u(*shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=g) * (hi - lo) + lo).to(device)

    gbuf = u(nplanes, H, W)
    n = torch.randn((3, H, W), generator=g)
    gbuf[4:7] = (n / n.norm(dim=0)).to(device)
    gbuf[11] = u(H, W, lo=0.4)
    depth = u(H, W, lo=0.02, hi=0.2)
    depth[:32, 128:] = 0.0
    table = u(4, nf, 128, lo=-4.0, hi=4.0)
    table[:, 3:7] = table[:, 3:7].abs() + 1.0
    table[:, 11] = -2.0
    table[:, 12] = 1.0
    counts = torch.tensor([20, 7, 0, 13], dtype=torch.int32, device=device)
    inv_vp = torch.tensor([[0.8, 0.0, 0.0, 0.0], [0.0, 0.45, 0.0, 0.0],
                           [0.0, 0.0, 0.0, -1.0], [0.0, 0.0, 10.0, 0.1]])
    params = torch.cat([inv_vp.reshape(16), torch.tensor(
        [0.3, -0.8, -0.5, 1.0, 0.9, 0.8, 0.05, 0.05, 0.06, W, H,
         0.1, 0.1, 0.13, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
         0.0])]).to(device)
    return gbuf, depth, table, counts, params, u(H, W)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(spot=False, clearcoat=False),
    dict(spot=True, rect=True, clearcoat=True, anisotropy=True,
         reflectance=True, specular_tint=True)], ids=["point", "all"])
def test_shade_kernel_matches_plain_on_card(flags):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    gbuf, depth, table, counts, params, sh = _shade_case("cuda")
    n0 = shade.deferred_shade.launches
    for shadow in (None, sh):
        got = shade.deferred_shade(gbuf, depth, table, counts, params, shadow,
                                   **flags)
        want = shade._deferred_shade_plain(gbuf, depth, table, counts, params,
                                           shadow, **flags)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert shade.deferred_shade.launches == n0 + 2
    with pytest.raises(ValueError):
        shade.deferred_shade(gbuf, depth, table, counts.long(), params)


def _sprite_case(device="cpu"):
    """Six sprites over a 40 x 200 frame (two bin tiles, two splat strips):
    textured and solid, one rotated solid, equal z at the back."""
    rng = np.random.RandomState(1)
    n = 6
    center = torch.tensor(rng.uniform(0, 200, (n, 2)) * [1, 0.2],
                          dtype=torch.float32)
    packed = raster2d.pack_sprite_instances(
        center=center, half=torch.full((n, 2), 12.0),
        rot=torch.tensor([0, 0, 0.7, 0, 0, 0], dtype=torch.float32),
        color=torch.tensor(rng.uniform(0.2, 1, (n, 4)), dtype=torch.float32),
        uv_min=torch.zeros(n, 2), uv_max=torch.ones(n, 2),
        tex=torch.tensor([0, -1, -1, 0, 0, -1]),
        z=torch.tensor([0, 0, 1, 2, 3, 4], dtype=torch.float32),
        active=torch.ones(n, dtype=torch.bool))
    fb = torch.tensor(rng.uniform(0, 1, (4, 40, 200)), dtype=torch.float32)
    atlas = torch.tensor(rng.uniform(0, 1, (4, 8, 8)), dtype=torch.float32)
    return fb.to(device), packed.to(device), atlas.to(device)


def _sprite_kernels(fb, packed, atlas, bf16):
    """B4 and B5 on one case, through their preparation."""
    _, H, W = fb.shape
    pk, pair, starts, counts, _ = raster2d.bin_sprites(packed, H, W)
    b4 = raster2d.sprite_tiles(fb, pk, pair, starts, counts, atlas,
                               bf16=bf16)
    pk5, win, bw, bs, bc, _ = raster2d_splat.build_sprite_windows(
        packed, H, W)
    b5 = raster2d_splat.sprite_splat(fb, pk5, win, bw, bs, bc, atlas,
                                     bf16=bf16)
    return (b4, (pk, pair, starts, counts)), (b5, (pk5, win, bw, bs, bc))


def test_sprite_wrappers_take_plain_version_on_cpu():
    raster2d.sprite_tiles.launches = 0
    raster2d_splat.sprite_splat.launches = 0
    fb, packed, atlas = _sprite_case()
    (b4, _), (b5, _) = _sprite_kernels(fb, packed, atlas, bf16=False)
    # both rasters draw the same sprites in the same order
    assert torch.allclose(b4, b5, atol=1e-5)
    assert not torch.equal(b4, fb)
    assert raster2d.sprite_tiles.launches == 0
    assert raster2d_splat.sprite_splat.launches == 0
    assert _cuda._Loaded.lib is None


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sprite_kernels_match_plain_on_card(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    fb, packed, atlas = _sprite_case("cuda")
    n4 = raster2d.sprite_tiles.launches
    n5 = raster2d_splat.sprite_splat.launches
    (b4, a4), (b5, a5) = _sprite_kernels(fb, packed, atlas, bf16)
    p4 = raster2d._sprite_tiles_plain(fb, *a4, atlas, bf16=bf16)
    p5 = raster2d_splat._sprite_splat_plain(fb, *a5, atlas, bf16=bf16)
    torch.cuda.synchronize()
    assert torch.equal(b4, p4) and torch.equal(b5, p5)
    assert raster2d.sprite_tiles.launches == n4 + 1
    assert raster2d_splat.sprite_splat.launches == n5 + 1
    # B5's per-warp cull: sprites straddling 32-column boundaries
    from torch_scenes import b5_straddle_scene
    for rot in (False, True):
        fb5, p, atlas5 = b5_straddle_scene(10, "cuda", rot)
        lists = raster2d_splat.build_sprite_windows(
            p, fb5.shape[1], fb5.shape[2], windows_per_sprite=8)[:5]
        kw = dict(bf16=bf16, rotated=rot)
        k5 = raster2d_splat.sprite_splat(fb5, *lists, atlas5, **kw)
        q5 = raster2d_splat._sprite_splat_plain(fb5, *lists, atlas5, **kw)
        torch.cuda.synchronize()
        assert torch.equal(k5.view(torch.int32), q5.view(torch.int32))
    with pytest.raises(ValueError):
        raster2d.sprite_tiles(fb, a4[0], a4[1].long(), a4[2], a4[3], atlas)


def _tri_calls(device="cpu"):
    """B7 / B8's six instantiations on chip_smoke.tri_scene (whose
    triangles 240-259 repeat earlier ones exactly, later in the list)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import tri_scene, tri_scene_calls
    return tri_scene(device), tri_scene_calls(device)


@pytest.mark.parametrize("case", range(6), ids=[
    f"{lay}-{sc}" for lay in ("corners", "planes", "planes_gbuf")
    for sc in ("full", "scissor")])
def test_tri_wrapper_takes_plain_version_on_cpu(case):
    """On CPU tensors raster_tris runs its plain version and launches
    nothing; the list order holds (an exact duplicate later in a tile's
    list never takes a pixel from the earlier triangle: `z > depth` is
    strict) and G-buffer planes 12 and up pass through."""
    tris.raster_tris.kernel_launches.update(B7=0, B8=0)
    scene, calls = _tri_calls()
    a, kw = calls[case]
    fb, dep = tris.raster_tris(*a, **kw)
    assert fb.shape == a[0].shape and dep.shape == a[1].shape
    alpha = fb[3].numpy()
    assert not np.isin(alpha, scene["colors"][240:260, 3].numpy()).any()
    assert np.isin(alpha, scene["colors"][:240, 3].numpy()).mean() > 0.2
    assert torch.equal(fb[12:], a[0][12:])
    assert tris.raster_tris.kernel_launches == {"B7": 0, "B8": 0}
    assert _cuda._Loaded.lib is None


@pytest.mark.cuda
def test_tri_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs in chip_smoke.py's environment)")
    _, calls = _tri_calls("cuda")
    n0 = dict(tris.raster_tris.kernel_launches)
    for a, kw in calls:
        fk, dk = tris.raster_tris(*a, **kw)
        fp, dp = tris._raster_tris_plain(*a, **kw)
        torch.cuda.synchronize()
        assert torch.equal(fk.view(torch.int32), fp.view(torch.int32))
        assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    assert tris.raster_tris.kernel_launches == {"B7": n0["B7"] + 2,
                                                "B8": n0["B8"] + 4}
    a, kw = calls[0]
    with pytest.raises(ValueError):
        tris.raster_tris(*a[:3], a[3].long(), *a[4:], **kw)
    with pytest.raises(ValueError, match="different devices"):
        tris.raster_tris(a[0].cpu(), *a[1:], **kw)
