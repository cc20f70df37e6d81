"""Inputs shared by the port's CPU tests and chip_smoke.py: the sprite
scenes, the scenes that stress the culls of kernels B1 (window-splat
raster) and B5 (window-splat sprite raster), and the two slivers of the
B7 / B8 scene (SLIVER_CORNERS, with_slivers), the group-route worlds
on the shade records (shade_record_world), and the deferred worlds of the
shadow maps and the specular tint / anisotropy materials (shadow_world,
material_world, caster_pass), and the 2D worlds beyond the example
twins (text_world, gizmo_world, slice_world, carried_world). Each builds
its tensors from a seed with numpy and moves them to the `device` it is
given; the worlds build with either package's modules (SCENE_MODULES)."""

import numpy as np
import torch


def sprite_scene(seed, device, n=60, H=80, W=200, rot=False, big=False,
                 ties=False, atlas_hw=16):
    """The sprite scenes of tests/test_torch_sprite.py, on `device`:
    packed (n, 17) sprites (some off-screen, 30% exactly opaque, 30% with
    flipped uv, 70% textured unless rotated, z in 6 levels or all equal,
    10% inactive), a framebuffer and a smooth (4, atlas_hw, atlas_hw)
    atlas."""
    rng = np.random.RandomState(seed)
    p = np.zeros((n, 17), np.float32)
    p[:, 0] = rng.uniform(-10, W + 10, n)
    p[:, 1] = rng.uniform(-10, H + 10, n)
    p[:, 2:4] = rng.uniform(2, 40 if big else 14, (n, 2))
    ang = rng.uniform(-3, 3, n) if rot else np.zeros(n)
    p[:, 4], p[:, 5] = np.cos(ang), np.sin(ang)
    p[:, 6:9] = rng.uniform(0.1, 1, (n, 3))
    p[:, 9] = np.where(rng.uniform(size=n) < 0.3, 1.0,
                       rng.uniform(0.3, 1, n))
    p[:, 12:14] = 1.0
    flip = rng.uniform(size=n) < 0.3
    p[flip, 10], p[flip, 12] = 1.0, 0.0
    p[:, 14] = np.where((rng.uniform(size=n) < 0.7) & (not rot), 0.0, -1.0)
    p[:, 15] = 0.0 if ties else rng.randint(0, 6, n)
    p[:, 16] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    fb = rng.uniform(0, 1, (4, H, W)).astype(np.float32)
    k = np.arange(atlas_hw, dtype=np.float32)
    yy, xx = np.meshgrid(k, k, indexing="ij")
    c = (atlas_hw - 1) / 2
    atlas = np.stack([xx / (atlas_hw - 1), yy / (atlas_hw - 1),
                      (xx + yy) % 2,
                      np.clip(np.hypot(xx - c, yy - c) / (c + 0.5), 0, 1)])
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (fb, p, atlas)]


def b5_straddle_scene(seed, device, rot, n=96, H=72, W=200):
    """The scene of sprite_scene with every sprite centred within 2 px of
    a 32-column boundary (B5's warp segments), half-sizes from 0.2 px
    (between two pixel centres) to 40 px; rotated or axis-aligned."""
    fb, p, atlas = sprite_scene(seed, device, n=n, H=H, W=W, rot=rot,
                                atlas_hw=8)
    rng = np.random.RandomState(seed + 100)
    p[:, 0] = torch.tensor(32.0 * rng.randint(0, W // 32 + 2, n)
                           + rng.uniform(-2, 2, n), device=device)
    p[:, 2:4] = torch.tensor(rng.choice([0.2, 0.5, 0.7, 3.0, 16.0, 40.0],
                                        (n, 2)), device=device)
    return fb, p, atlas


def b1_sliver_corners(seed=0, n_cl=24, cs=4, width=200, height=100):
    """Clip-space corners (n_cl * cs, 3, 4) of thin triangles: each a
    random segment of the frame (or up to 40 px past its edges) with its
    third corner 1e-3..1 px off the segment's middle, at a random w in
    [0.5, 3], either winding (back-facing ones become padding slots)."""
    rng = np.random.RandomState(seed)
    t = n_cl * cs
    a = rng.uniform([-40, -40], [width + 40, height + 40], (t, 2))
    b = a + rng.uniform(-60, 60, (t, 2))
    d = b - a
    off = rng.choice([1e-3, 1e-2, 0.1, 1.0], t) * rng.choice([-1, 1], t)
    c = (a + b) / 2 + off[:, None] * np.stack([-d[:, 1], d[:, 0]], 1) / \
        np.maximum(np.linalg.norm(d, axis=1), 1e-6)[:, None]
    scr = np.stack([a, b, c], 1)                                # (t, 3, 2)
    w = rng.uniform(0.5, 3.0, (t, 3))
    cc = np.zeros((t, 3, 4), np.float32)
    cc[..., 0] = (scr[..., 0] / width * 2 - 1) * w
    cc[..., 1] = (1 - scr[..., 1] / height * 2) * w
    cc[..., 2] = rng.uniform(0.1, 0.9, (t, 3)) * w
    cc[..., 3] = w
    return cc


def b1_random_rows(seed=1, n_cl=16, ntri=6, nedge=3):
    """(n_cl, rrows, 128) record rows of random planes: coefficients of
    every magnitude from 1e-33 to 1e33, exact zeros, infinities and
    NaNs."""
    rng = np.random.RandomState(seed)
    stride = 3 * nedge + 4
    r = rng.standard_normal((n_cl, ntri, stride)) * \
        10.0 ** rng.uniform(-3, 3, (n_cl, ntri, stride))
    r[..., 2::3] *= 300.0                        # offsets the size of px
    for frac, f in ((0.05, 0.0), (0.02, 1e30), (0.02, 1e-30)):
        r[rng.uniform(size=r.shape) < frac] *= f
    for frac, v in ((0.01, np.inf), (0.01, -np.inf), (0.01, np.nan)):
        r[rng.uniform(size=r.shape) < frac] = v
    rrows = (ntri * stride + 127) // 128
    rows = np.zeros((n_cl, rrows * 128), np.float32)
    rows[:, :ntri * stride] = r.reshape(n_cl, -1)
    return torch.from_numpy(rows.reshape(n_cl, rrows, 128))


def b1_cull_scenes(device):
    """B1 calls that stress its cull, by name: (rec_rows, depth, winner,
    owner, meta, wvalid, keywords, (H, W)). "slivers": b1_sliver_corners
    through the port's setup and windows (3-edge records, padding slots,
    windows past the frame's right and bottom edges); "random_planes":
    b1_random_rows over 48 windows at unaligned rows of a 100 x 200
    frame; "many_slots" (40 slots of 3 edges, 256-row windows: two slot
    groups, over 32 blocks a window, past the 48 KB a CTA has without
    opting in; some negative depths) and "tall_quads" (40 slots of 4
    edges, 1200-row windows: 300 blocks, fewer than eight windows a CTA):
    random planes over a 1280 x 200 frame."""
    from bevy_tpu_torch.ops import raster3d_splat as splat
    from bevy_tpu_torch.ops import raster3d_visbuf as vis

    def fb(rng, h, w):
        depth = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.3,
                                          rng.uniform(0.0, 0.5, (h, w)), 0.0)
                                 .astype(np.float32))
        # a few negative depths: zero-depth-plane slots may write there
        neg = torch.where(torch.from_numpy(rng.uniform(size=(h, w)) < 0.05),
                          -0.25, depth)
        return depth, neg, torch.full((h, w), -1.0)

    h, w = 100, 200
    rng = np.random.RandomState(2)
    out = {}
    cc = torch.from_numpy(b1_sliver_corners(width=w, height=h))
    zrec, valid = vis.pack_planes_h(cc, torch.zeros(cc.shape[:-1] + (3,)),
                                    torch.ones(cc.shape[0], dtype=torch.bool),
                                    w, h)
    aabb, cl_valid, _ = vis.cluster_screen_aabbs(
        cc, torch.ones(1, dtype=torch.bool), valid, 4, w, h)
    wins = splat.build_windows(aabb, cl_valid, win_h=16, width=w, height=h,
                               budget=512)
    out["slivers"] = (splat.build_rec_rows(zrec, 4, 4), wins["owner"],
                      wins["meta"], wins["wvalid"],
                      dict(win_h=16, ntri=4, nedge=3))
    nb = 48
    meta = rng.randint(0, 2, nb) * 2048 + rng.randint(0, h, nb)
    out["random_planes"] = (
        b1_random_rows(), torch.from_numpy(rng.randint(0, 16, nb).astype(
            np.int32)), torch.from_numpy(meta.astype(np.int32)),
        torch.ones(nb, dtype=torch.bool), dict(win_h=16, ntri=6, nedge=3))
    depth, neg, winner = fb(rng, h, w)
    frames = {"slivers": (depth, winner), "random_planes": (neg, winner)}
    rng = np.random.RandomState(3)
    tall = fb(rng, 1280, w)
    for name, nedge, win_h in (("many_slots", 3, 256),
                               ("tall_quads", 4, 1200)):
        nb = 8
        meta = rng.randint(0, 2, nb) * 2048 + rng.randint(0, 80, nb)
        out[name] = (
            b1_random_rows(seed=nedge, n_cl=4, ntri=40, nedge=nedge),
            torch.from_numpy(rng.randint(0, 4, nb).astype(np.int32)),
            torch.from_numpy(meta.astype(np.int32)),
            torch.ones(nb, dtype=torch.bool),
            dict(win_h=win_h, ntri=40, nedge=nedge))
        frames[name] = (tall[1] if nedge == 3 else tall[0], tall[2])
    return {k: (rows.to(device), frames[k][0].to(device),
                frames[k][1].to(device), o.to(device), m.to(device),
                v.to(device), kw, tuple(frames[k][0].shape))
            for k, (rows, o, m, v, kw) in out.items()}


# Two slivers in tri_scene's 320x180 frame (screen corners ax ay bx by cx
# cy, |area2| 5e-5 and 2e-4 px^2, each across a 16-px block edge) whose
# float edges read a pixel centre inside well past their AABB, in a tile
# they are listed in: the first (106.5, 59.5), 18 px left of its AABB in
# another 16x16 block; the second (239.5, 25.5), in its block but two
# row pairs below. Only B7's sliver rule keeps them there; B8's
# cull tests the edges' own arithmetic, so it needs no such rule.
SLIVER_CORNERS = np.array(
    [[138.91505, 49.391125, 177.12376, 37.475452, 124.366, 53.928356],
     [233.24269, -10.04426, 229.31094, -32.37828, 238.75624, 21.27512]],
    np.float32)
SLIVER_INSIDE = ((106.5, 59.5), (239.5, 25.5))


def with_slivers(setup, s):
    """triangle_setup_corners' `setup` and tri_scene's `s` with the
    SLIVER_CORNERS triangles appended (NDC depth 0.9, w 1, normal +z,
    their own colours)."""
    dev = setup["corners"].device
    c = torch.tensor(SLIVER_CORNERS, device=dev).reshape(-1, 3, 2)
    k = c.shape[0]
    ax, ay, bx, by, cx, cy = c.reshape(k, 6).unbind(1)
    area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    assert bool((area2 < -1e-12).all())
    aabb = torch.stack([c[..., 0].amin(1), c[..., 1].amin(1),
                        c[..., 0].amax(1), c[..., 1].amax(1)], 1)
    add = dict(corners=c, depth=torch.full((k, 3), 0.9, device=dev),
               inv_w=torch.ones((k, 3), device=dev), area2=area2,
               valid=torch.ones(k, dtype=torch.bool, device=dev), aabb=aabb)
    setup = {n: torch.cat([v, add[n]]) for n, v in setup.items()}
    nrm = torch.zeros((k, 3, 3), device=dev)
    nrm[..., 2] = 1.0
    add = dict(normals=nrm, colors=torch.tensor(
        [[0.9, 0.2, 0.2, 0.03125], [0.2, 0.9, 0.2, 0.0625]], device=dev),
        emissive=torch.zeros((k, 3), device=dev),
        metallic=torch.full((k,), 0.5, device=dev),
        roughness=torch.full((k,), 0.5, device=dev))
    return setup, {n: torch.cat([v, add[n]]) if n in add else v
                   for n, v in s.items()}


def b2_scenes(device):
    """B2 calls off the mesh pass's beaten track, by name: (args, keywords)
    of raster_visbuf. "slivers": b1_sliver_corners' thin triangles (either
    winding, across tile and block edges) in clusters of 4 over a 100 x 200
    frame of 16 x 128 tiles (the last tile row and column cut by the frame);
    "straddlers": random large triangles, a third with a corner behind the
    eye (full-viewport AABBs), in clusters of 12 over a 90 x 202 frame (a
    width that is not a multiple of 4: most rows start off a 16-byte
    boundary) of 32 x 96 tiles; both over a depth holding 0.5 on a fifth
    of the pixels."""
    from bevy_tpu_torch.ops import raster3d_visbuf as vis

    def call(cc, cs, h, w, tile_h, tile_w, seed):
        t = cc.shape[0]
        zrec, valid = vis.pack_planes_h(
            cc, torch.zeros(cc.shape[:-1] + (3,)),
            torch.ones(t, dtype=torch.bool), w, h)
        aabb, cl_valid, zmax = vis.cluster_screen_aabbs(
            cc, torch.ones(1, dtype=torch.bool), valid, cs, w, h)
        ntx, nty = -(-w // tile_w), -(-h // tile_h)
        key = torch.clamp((1.0 - zmax) * 65535.0, 0, 65535).to(torch.int32)
        table, counts, _ = vis.bin_clusters(
            aabb, cl_valid, ntx=ntx, nty=nty, tile_w=tile_w, tile_h=tile_h,
            max_clusters_per_tile=t // cs, pair_budget=4 * t + 64,
            order_key=key)
        rng = np.random.RandomState(seed)
        depth = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.2,
                                          0.5, 0.0).astype(np.float32))
        winner = torch.full((h, w), -1.0)
        args = (depth, winner, vis.cluster_records(zrec, cs), table, counts)
        return (tuple(x.to(device) for x in args),
                dict(tile_h=tile_h, tile_w=tile_w, cs=cs))

    out = {"slivers": call(torch.from_numpy(b1_sliver_corners()), 4, 100,
                           200, 16, 128, 0)}
    rng = np.random.RandomState(5)
    n, h, w = 48 * 12, 90, 202
    ndc = rng.uniform(-1.5, 1.5, (n, 1, 2)) + rng.uniform(-0.8, 0.8, (n, 3, 2))
    wc = rng.uniform(0.5, 3.0, (n, 3))
    wc[rng.uniform(size=n) < 0.33, rng.randint(0, 3)] *= -1.0
    cc = np.zeros((n, 3, 4), np.float32)
    cc[..., 0:2] = ndc * np.abs(wc)[..., None]
    cc[..., 2] = rng.uniform(0.1, 0.9, (n, 3)) * np.abs(wc)
    cc[..., 3] = wc
    out["straddlers"] = call(torch.from_numpy(cc), 12, h, w, 32, 96, 1)
    return out


# the modules shade_record_world builds with, by key: the package's name
# followed by these suffixes (the JAX package and the port share them)
SCENE_MODULES = {
    "root": "", "render": ".render", "cam": ".render.camera",
    "mesh": ".render.mesh", "m3": ".render.mesh3d",
    "plug": ".render.plugin", "tex": ".render.texture", "time": ".time",
    "tf": ".transform", "deferred": ".render.deferred",
    "shadow": ".render.shadow", "spot": ".render.spot_shadow",
    "point": ".render.point_shadow", "sprite": ".render.sprite",
    "text": ".render.text", "rich": ".render.rich_text",
    "gizmos": ".render.gizmos", "tilemap": ".render.tilemap",
    "system": ".ecs.system", "post": ".render.post",
    "trans": ".render.transmission",
    "skybox": ".render.skybox", "fog": ".render.fog",
    "atmo": ".render.atmosphere", "env": ".render.environment",
    "irr": ".render.irradiance", "ssr": ".render.ssr",
    "contact": ".render.contact_shadows", "decal": ".render.decal",
    "wire": ".render.wireframe"}


def port_scene_modules():
    """SCENE_MODULES of bevy_tpu_torch, imported."""
    import importlib
    return {k: importlib.import_module(f"bevy_tpu_torch{v}")
            for k, v in SCENE_MODULES.items()}


def shade_record_world(m, kind, app_kw, plugin_kw):
    """One frame of a group-route world on the shade-record path, built
    with the modules `m` (SCENE_MODULES of either package, imported by the
    caller); app_kw go to App (the port's device), plugin_kw to
    Mesh3dPlugin (JAX's backend). Returns (sRGB image (H, W, 4) int, app).

    "atlas": five smooth spheres of one mesh (one uniform batch) with the
    material atlas: the half-red / half-green texture of
    tests/test_mesh_texture.py; the checkerboard over a step depth map of
    tests/test_parallax.py (parallax occlusion, 8 layers); a normal map
    (tests/test_normal_map.py) with emissive, metallic-roughness and
    occlusion textures and a lightmap (tests/test_channel_textures.py,
    test_lightmap.py) and a uv transform; two with no texture.
    "smooth": no atlas; smooth spheres (the shade records without
    textures) beside flat cubes (the flat records)."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    app = m["root"].App(capacity=16, **app_kw)
    atlas = None if kind == "smooth" else m["tex"].AtlasBuilder(256, 128)
    plugin = m3.Mesh3dPlugin(atlas=atlas, parallax_layers=8, **plugin_kw)
    turn = (-0.2, 0.35, 0.0, 0.915)
    items = []                                # (mesh, material, transform)
    if kind == "atlas":
        img = np.zeros((32, 32, 4), np.float32)
        img[:, :16] = (1.0, 0.05, 0.05, 1.0)
        img[:, 16:] = (0.05, 1.0, 0.05, 1.0)
        h = atlas.add(img, srgb=False)
        tex = atlas.add(m["tex"].checkerboard(64, 8), srgb=False)
        dm = np.zeros((64, 64, 4), np.float32)
        dm[:, :32, 0] = 1.0
        dmap = atlas.add(dm, srgb=False)
        nm = np.zeros((16, 16, 4), np.uint8)
        nm[:, :8] = (40, 128, 230, 255)
        nm[:, 8:] = (215, 128, 230, 255)
        nmh = atlas.add(nm, srgb=False)
        rng = np.random.RandomState(6)
        ch = {k: atlas.add(rng.uniform(0.2, 1, (8, 8, 4)).astype(
            np.float32), srgb=False) for k in ("em", "mr", "oc", "lm")}
        white = (1.0, 1.0, 1.0, 1.0)
        sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.5, 16, 8))
        mats = [
            dict(base_color=white, uv_min=h["uv_min"], uv_max=h["uv_max"]),
            dict(base_color=white, uv_min=tex["uv_min"],
                 uv_max=tex["uv_max"], dm_min=dmap["uv_min"],
                 dm_max=dmap["uv_max"], parallax_depth_scale=0.12),
            dict(base_color=(0.8, 0.7, 0.6, 1.0), emissive=(0.3, 0.1, 0.0),
                 uv_min=tex["uv_min"], uv_max=tex["uv_max"],
                 nm_min=nmh["uv_min"], nm_max=nmh["uv_max"],
                 uv_transform=(2.0, 0.3, -0.2, 1.5, 0.25, -0.1),
                 perceptual_roughness=0.6, metallic=0.2,
                 **{f"{k}_{e}": hh[f"uv_{e}"] for k, hh in ch.items()
                    for e in ("min", "max")}),
            dict(base_color=(0.3, 0.6, 0.9, 1.0)),
            dict(base_color=(0.9, 0.8, 0.2, 1.0), emissive=(0.1, 0.0, 0.1)),
        ]
        for i, kw in enumerate(mats):
            items.append((sphere, kw, dict(
                translation=(-1.2 + 0.6 * i, 0.25 * (i % 2), -0.6 * (i % 3)),
                rotation=turn, scale=(0.9, 0.9, 0.9))))
    else:
        sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.5, 16, 8))
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        for i, x in enumerate((-0.9, -0.3, 0.3, 0.9)):
            items.append((cube if i % 2 else sphere,
                          dict(base_color=(0.9, 0.5 + 0.1 * i, 0.3, 1.0),
                               emissive=(0.0, 0.0, 0.05 * i)),
                          dict(translation=(x, 0.1 * i, -0.4 * i),
                               rotation=turn, scale=(0.7, 0.7, 0.7))))
    app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                    m["render"].RenderPlugin(width=160, height=96), plugin)
    app.insert_resource(m3.AmbientLight(brightness=0.35))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0.6, 2.6),
                                             rotation=(-0.1, 0, 0, 0.995)))
    app.world.spawn(m3.DirectionalLight(illuminance=2.0),
                    *tb(rotation=(-0.5, 0.2, 0.0, 0.84)))
    for mid, kw, t in items:
        app.world.spawn(m3.Mesh3d(mesh=mid), m3.MeshMaterial(**kw), *tb(**t))
    app.update(dt=1 / 60)
    return m["plug"].frame_image(app).astype(int), app


DOWN = (-0.7071, 0.0, 0.0, 0.7071)            # -Z turned to -Y


def shadow_world(m, kind, app_kw, jax_kw, shadows=True, occluder=True,
                 cascades=2, occluder_at=None, shards=None):
    """One frame (or `frames`) of the deferred shadow worlds of
    tests/test_shadow.py ("dir": a directional light, ShadowPlugin with
    maps of 256, extent 12, distance 20 and `cascades`),
    tests/test_spot_shadow.py ("spot": a spot straight down, maps of 256)
    and tests/test_point_shadow.py ("point": a point light over the floor,
    maps of 128), at 160x96, built with the modules `m` (SCENE_MODULES of
    either package); app_kw go to App (the port's device), jax_kw to every
    JAX plugin ({"backend": "pallas_interpret"}: its kernels in interpret
    mode). `shadows` False leaves the ShadowPlugin out ("dir") or gives the
    light shadows=0 (the binned shade); `occluder` adds the red cube at
    `occluder_at` (the last Mesh3d row); `shards` (the port) shades in row
    bands. Returns (sRGB image (H, W, 4) int, app)."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    cube_mesh = m["mesh"].cuboid(1.0, 1.0, 1.0)
    app = m["root"].App(capacity=32, **app_kw)
    plugin = m3.Mesh3dPlugin(deferred=True, **jax_kw)
    cube = plugin.add_mesh(cube_mesh)
    plugins = [m["time"].TimePlugin(), m["tf"].TransformPlugin(),
               m["render"].RenderPlugin(width=160, height=96), plugin,
               m["deferred"].DeferredLightingPlugin(
                   **jax_kw, **({} if shards is None else {"shards": shards}))]
    if kind == "dir" and shadows:
        plugins.append(m["shadow"].ShadowPlugin(
            plugin, size=256, extent=12.0, distance=20.0, cascades=cascades,
            **jax_kw))
    elif kind == "spot":
        plugins.append(m["spot"].SpotShadowPlugin(plugin, size=256,
                                                  **jax_kw))
    elif kind == "point":
        plugins.append(m["point"].PointShadowPlugin(plugin, size=128,
                                                    **jax_kw))
    app.add_plugins(*plugins)
    app.insert_resource(m3.AmbientLight(
        brightness=0.05 if kind == "dir" else 0.03))
    app.world.spawn(m["cam"].Camera3d(), *tb(
        translation=(0.0, 10.0 if kind == "dir" else 8.0, 0.01),
        rotation=DOWN))
    if kind == "dir":
        app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                        *tb(rotation=(-0.35, 0.35, 0.0, 0.87)))
    elif kind == "spot":
        app.world.spawn(m["deferred"].SpotLight(
            intensity=60.0, range=30.0, inner_angle=0.5, outer_angle=0.8,
            shadows=int(shadows)), *tb(translation=(0.0, 6.0, 0.0),
                                       rotation=DOWN))
    else:
        app.world.spawn(m["deferred"].PointLight(
            intensity=60.0, range=30.0, shadows=int(shadows)),
            *tb(translation=(0.0, 5.0, 0.0)))
    floor = 20.0 if kind == "dir" else 16.0
    app.world.spawn(m3.Mesh3d(mesh=cube),
                    m3.MeshMaterial(base_color=(0.8, 0.8, 0.8, 1.0)),
                    *tb(translation=(0.0, -0.5, 0.0),
                        scale=(floor, 1.0, floor)))
    if occluder:
        at = occluder_at or (0.0, 1.5 if kind == "dir" else 2.0, 0.0)
        app.world.spawn(m3.Mesh3d(mesh=cube),
                        m3.MeshMaterial(base_color=(0.8, 0.2, 0.2, 1.0)),
                        *tb(translation=at))
    app.update(dt=1 / 60)
    return m["plug"].frame_image(app).astype(int), app


def material_world(m, kind, app_kw, jax_kw, value, metallic=0.0, rot=0.0,
                   rough=None, hidden_aniso=False):
    """One frame of the deferred sphere of tests/test_specular_tint.py
    ("tint": `value` the specular tint, 96x72, roughness 0.15) or
    tests/test_anisotropy.py ("aniso": `value` the anisotropy strength,
    `rot` its rotation, metallic, 128x96, roughness 0.35), one point
    light, built with the modules `m` as shadow_world. `hidden_aniso`
    adds the second sphere behind the camera with strength 0.8 (the
    anisotropic variant for a visible sphere without anisotropy). Returns
    (sRGB image (H, W, 4) int, linear colour (H, W, 4) float, app)."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    tint = kind == "tint"
    app = m["root"].App(capacity=16, **app_kw)
    plugin = m3.Mesh3dPlugin(deferred=True, **jax_kw)
    sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.9, 24, 16))
    app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                    m["render"].RenderPlugin(width=96 if tint else 128,
                                             height=72 if tint else 96),
                    plugin, m["deferred"].DeferredLightingPlugin(**jax_kw))
    app.insert_resource(m3.AmbientLight(brightness=0.02))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 3)))
    app.world.spawn(m["deferred"].PointLight(
        intensity=30.0 if tint else 20.0, range=40.0 if tint else 30.0),
        *tb(translation=(1.5, 1.5, 2.5) if tint else (0.5, 0.5, 2.5)))
    if tint:
        mat = dict(base_color=(0.5, 0.5, 0.5, 1.0), metallic=metallic,
                   perceptual_roughness=0.15, specular_tint=value)
    else:
        mat = dict(base_color=(0.2, 0.2, 0.25, 1.0),
                   perceptual_roughness=rough or 0.35, metallic=1.0,
                   anisotropy_strength=value, anisotropy_rotation=rot)
    app.world.spawn(m3.Mesh3d(mesh=sphere), m3.MeshMaterial(**mat), *tb())
    if hidden_aniso:
        app.world.spawn(m3.Mesh3d(mesh=sphere),
                        m3.MeshMaterial(anisotropy_strength=0.8),
                        *tb(translation=(0.0, 0.0, 30.0)))
    app.update(dt=1 / 60)
    color = np.asarray(app.world.state["res"]["render_target"]["color"])
    return (m["plug"].frame_image(app).astype(int),
            np.moveaxis(color, 0, -1), app)


CASTER_MAP = 512       # caster_pass's map: a straddler's full-map box
#                        exceeds B1's 32 windows, so it takes B2


def caster_pass(seed=0, n=6):
    """A fixed caster set for one depth-only pass into a CASTER_MAP map:
    clip-space positions (n, 24, 4) of `n` unit cubes at random poses under
    a light's perspective view (two straddling its near plane), as
    numpy."""
    rng = np.random.RandomState(seed)
    from bevy_tpu_torch.render.mesh import cuboid
    pos = cuboid(1.0, 1.0, 1.0).positions
    fov, near = 1.2, 0.1
    f = 1.0 / np.tan(fov / 2)
    out = np.zeros((n, len(pos), 4), np.float32)
    for i in range(n):
        a = rng.normal(size=3)
        ang = np.linalg.norm(a)
        k = a / ang
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        r = np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx
        c = np.array([rng.uniform(-2, 2), rng.uniform(-2, 2),
                      -rng.uniform(0.3, 6)]) if i % 3 else \
            np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), -0.4])
        v = pos @ r.T * rng.uniform(0.5, 1.5) + c
        out[i, :, 0] = f * v[:, 0]
        out[i, :, 1] = f * v[:, 1]
        out[i, :, 2] = near
        out[i, :, 3] = -v[:, 2]
    return out


# the outputs in tests/goldens/ that tests/make_torch_goldens.py renders
# through the JAX package, each with its scene builder's arguments after
# the modules and keywords (`value` of material_world; the caster map has
# none)
GOLDEN_SCENES = {
    "shadow_dir_c2": (shadow_world, ("dir",)),
    "shadow_spot": (shadow_world, ("spot",)),
    "shadow_point": (shadow_world, ("point",)),
    "tint_red": (material_world, ("tint", (1.0, 0.05, 0.05))),
    "aniso_09": (material_world, ("aniso", 0.9)),
    "shadow_caster_depth": (caster_pass, ()),
}


def alien_world(mod, app_kw, width, height, backend, frames):
    """alien_cake_addict built with `mod` (the JAX example or its twin,
    examples/torch_alien_cake_addict.py) at width x height on `backend`,
    after `frames` frames of the twin's scripted chase. Returns (the
    sRGB frame (H, W, 4) int, the trajectory rows: player cell, cake cell
    (-1 without a live cake), score a frame)."""
    import importlib
    twin = importlib.import_module("torch_alien_cake_addict")
    app = mod.build_app(width=width, height=height, backend=backend,
                        **app_kw)
    rows = []
    for _ in range(frames):
        twin.steer(app)
        app.update(dt=1 / 60)
        rows.append(twin.trajectory_row(app))
    frame_image = importlib.import_module(
        type(app).__module__.split(".")[0] + ".render.plugin").frame_image
    return np.asarray(frame_image(app)).astype(int), rows


GOLDEN_SCENES.update({
    "alien_trajectory": (alien_world, (128, 80, "xla", 240)),
    "alien_f190": (alien_world, (128, 80, "pallas_interpret", 190)),
    "alien_f190_xla": (alien_world, (128, 80, "xla", 190)),
})


def golden_key(name):
    """A short sha256 of what renders the stored image `name`: its scene
    builder's source, the module constants the builders read and its
    arguments. tests/make_torch_goldens.py writes it into
    goldens/torch_goldens.json beside the image; the test asserts it, so
    a changed scene fails until its image is rendered again."""
    import hashlib
    import inspect
    fn, args = GOLDEN_SCENES[name]
    text = "\n".join([name, inspect.getsource(fn), repr(args), repr(DOWN),
                      repr(CASTER_MAP)])
    if fn in (post_world, aa_world, fog_world, ssr_world):
        text += "\n".join(["", inspect.getsource(_app_3d),
                           inspect.getsource(_run)])
    if fn in A8_BUILDERS:
        text += "\n".join([""] + [inspect.getsource(h) for h in A8_HELPERS]
                          + [repr(ROT_UP), repr(GOLDEN_BACKEND.get(name))])
    if fn in (occl_world, budget_world):
        text += inspect.getsource(_cube_field)
    if fn is alien_world:
        import importlib
        from pathlib import Path
        ex = Path(__file__).resolve().parent.parent / "examples"
        twin = importlib.import_module("torch_alien_cake_addict")
        text += (ex / "alien_cake_addict.py").read_text() + "".join(
            inspect.getsource(f) for f in (twin.build_app, twin.steer,
                                           twin.trajectory_row))
    return hashlib.sha256(text.encode()).hexdigest()[:16]



# ---------------------------------------------------------------------------
# 2D worlds: each built with the modules `m` (SCENE_MODULES of either
# package) and app_kw for App (the port's {"device": ...}; {} for JAX),
# no frame run. Their inputs are Python numbers, so the systems run under
# either package.

HEB = "שלום"       # shalom: no glyph in the default font


def _build_atlas(builder, app_kw):
    """The packed atlas (the port's builder takes the device)."""
    return builder.build(app_kw["device"]) if "device" in app_kw \
        else builder.build()


def _app_2d(m, app_kw, capacity, width, height, *plugins):
    app = m["root"].App(capacity=capacity, **app_kw)
    app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                    m["render"].RenderPlugin(width=width, height=height),
                    *plugins)
    app.world.spawn(m["cam"].Camera2d(), *m["tf"].transform_bundle())
    return app


def text_world(m, app_kw, width=240, height=160):
    """A 4-slot digit counter reading the frame count (DigitText), and a
    rich-text block over the default font (spawn_rich_text): spans of
    three sizes and colours, wrapped at 150 px and centred, a word longer
    than a line (split), and a Hebrew word in brackets (no glyph: laid out
    right to left with the first font's advance, not spawned)."""
    txt, rich = m["text"], m["rich"]
    app = _app_2d(m, app_kw, 256, width, height, m["sprite"].SpritePlugin())
    builder = m["tex"].AtlasBuilder(512, 256)
    font = txt.FontAtlas(builder)
    txt.spawn_digit_counter(app.world, font, num_digits=4,
                            pos=(-110.0, 75.0), color=(1.0, 0.9, 0.3, 1.0))
    app.add_systems(m["root"].Update,
                    txt.make_digit_system(font, "frame_count", "count"))
    spans = [rich.TextSpan("Big ", size=26.0, color=(1.0, 0.5, 0.3, 1.0)),
             rich.TextSpan("and small words wrap ", size=13.0),
             rich.TextSpan("unbreakablewordsplit ", size=9.75,
                           color=(0.5, 0.8, 1.0, 1.0)),
             rich.TextSpan("(" + HEB + ") end", size=13.0,
                           color=(0.6, 1.0, 0.6, 1.0))]
    rich.spawn_rich_text(app.world, spans, font, pos=(-110.0, 45.0),
                         max_width=150.0, justify="center")
    app.insert_resource(m["tex"].TextureAtlas.RESOURCE,
                        {"data": _build_atlas(builder, app_kw)})
    return app


def gizmo_world(m, app_kw, width=240, height=160):
    """2D, 3D and retained gizmos with stroke text: a Camera3d beside the
    Camera2d; every frame a system draws 2D stroke text, a circle, an arc,
    a cross and a rectangle, and 3D stroke text, a cuboid, a sphere, an XZ
    grid, an arrow, axes and a ray; two retained segments (2D and 3D, with
    a sprite's row between them: a masked row) draw too."""
    tb = m["tf"].transform_bundle
    gz = m["gizmos"]
    app = _app_2d(m, app_kw, 16, width, height, m["sprite"].SpritePlugin(),
                  gz.GizmosPlugin(capacity=1024))
    app.world.spawn(m["cam"].Camera3d(),
                    *tb(translation=(0.0, 2.0, 6.0),
                        rotation=(-0.1305, 0.0, 0.0, 0.9914)))
    app.world.spawn(gz.RetainedGizmo(a=(-100.0, -70.0, 0.0),
                                     b=(100.0, -60.0, 0.0),
                                     color=(0.9, 0.3, 0.9, 1.0), width=3.0,
                                     is3d=False))
    app.world.spawn(m["sprite"].Sprite(size=(12.0, 12.0),
                                       color=(0.3, 0.3, 0.9, 1.0)),
                    *tb(translation=(90.0, 60.0, 0.0)))
    app.world.spawn(gz.RetainedGizmo(a=(-1.0, 1.5, 0.0), b=(1.0, 1.0, -1.0),
                                     color=(0.3, 0.9, 0.9, 1.0)))

    @m["system"].system
    def draw(g=gz.Gizmos()):
        g.text_2d((-110.0, 62.0), "Gizmo 2D 42", size=10.0,
                  color=(1.0, 1.0, 0.4, 1.0))
        g.circle_2d((-70.0, 0.0), 25.0, color=(1.0, 0.4, 0.2, 1.0))
        g.arc_2d((70.0, 10.0), 20.0, 0.5, 3.0, color=(0.4, 1.0, 0.4, 1.0),
                 segments=12)
        g.cross_2d((0.0, -40.0), 8.0, color=(0.8, 0.8, 0.8, 1.0))
        g.rect_2d((60.0, -40.0), (40.0, 24.0), color=(0.2, 0.6, 1.0, 1.0),
                  width=1.0)
        g.text((-1.5, 1.8, 0.0), "3D", size=0.4, color=(1.0, 0.7, 0.7, 1.0))
        g.cuboid((0.0, 0.5, 0.0), (0.5, 0.5, 0.5),
                 color=(0.9, 0.9, 0.2, 1.0))
        g.sphere((1.6, 0.5, 0.0), 0.5, color=(0.2, 0.9, 0.5, 1.0),
                 segments=16)
        g.grid((0.0, 0.0, 0.0), (0.5, 0.5), (6, 4),
               color=(0.5, 0.5, 0.5, 1.0))
        g.arrow((-2.0, 0.2, 1.0), (-1.0, 1.2, 0.0),
                color=(1.0, 0.5, 0.0, 1.0))
        g.axes((1.5, 1.5, -1.0), length=0.6)
        g.ray((0.0, 0.0, 1.5), (0.8, 0.4, 0.0), color=(0.7, 0.2, 1.0, 1.0))

    app.add_systems(m["root"].Update, draw)
    return app


def slice_world(m, app_kw, width=200, height=120):
    """9-slice sprites (one border for all sides, and four borders) and
    tiled sprites (natural size; scale 1.5 with cropped edge tiles) of two
    small images, and a flipped sprite anchored at its top left."""
    sp = m["sprite"]
    app = _app_2d(m, app_kw, 256, width, height, sp.SpritePlugin())
    builder = m["tex"].AtlasBuilder(128, 128)
    ring = np.zeros((12, 12, 4), np.float32)
    ring[:] = (1.0, 0.0, 0.0, 1.0)
    ring[4:8, 4:8] = (0.0, 1.0, 0.0, 1.0)
    ring[0, :] = (1.0, 1.0, 0.0, 1.0)
    halves = np.zeros((10, 10, 4), np.float32)
    halves[:, :5] = (1.0, 0.0, 0.0, 1.0)
    halves[:, 5:] = (0.0, 0.0, 1.0, 0.8)
    h_ring = builder.add(ring, srgb=False)
    h_half = builder.add(halves, srgb=False)
    sp.spawn_sliced(app.world, h_ring, size=(70.0, 40.0), border=4,
                    pos=(-55.0, 25.0))
    sp.spawn_sliced(app.world, h_ring, size=(50.0, 36.0),
                    border=(2.0, 3.0, 4.0, 5.0), pos=(45.0, 25.0), z=11.0,
                    color=(0.8, 0.9, 1.0, 1.0))
    sp.spawn_tiled(app.world, h_half, size=(40.0, 20.0), pos=(-55.0, -30.0))
    sp.spawn_tiled(app.world, h_half, size=(53.0, 37.0), pos=(40.0, -30.0),
                   scale=1.5, color=(1.0, 1.0, 1.0, 0.9))
    app.world.spawn(sp.sprite_from_handle(h_half, size=(20.0, 14.0),
                                          anchor=sp.Anchor.TOP_LEFT,
                                          flip_x=True),
                    *m["tf"].transform_bundle(
                        translation=(-95.0, -45.0, 12.0)))
    app.insert_resource(m["tex"].TextureAtlas.RESOURCE,
                        {"data": _build_atlas(builder, app_kw)})
    return app


def carried_world(m, app_kw, width=160, height=96):
    """The state a world carries across packages: a tilemap chunk with
    empty cells, a 3-slot digit counter (DigitText, the frame count), an
    animated sheet sprite (AtlasAnimation, fps 7) and two retained 2D
    gizmos."""
    tb = m["tf"].transform_bundle
    sp, gz, tmap, txt = m["sprite"], m["gizmos"], m["tilemap"], m["text"]
    builder = m["tex"].AtlasBuilder(512, 160)
    font = txt.FontAtlas(builder)
    sheet = np.zeros((8, 32, 4), np.float32)
    for i, c in enumerate([(0.9, 0.2, 0.2), (0.2, 0.9, 0.2),
                           (0.2, 0.2, 0.9), (0.9, 0.9, 0.2)]):
        sheet[:, 8 * i:8 * (i + 1)] = (*c, 1.0)
    h_sheet = builder.add(sheet, srgb=False)
    frames = [builder.grid(h_sheet, 4, 1, i) for i in range(4)]
    tiles = np.random.RandomState(3).randint(-1, 4, (5, 8))
    tm = tmap.TilemapPlugin()
    tm.add_chunk(tmap.TilemapChunk(tiles, h_sheet, sheet_cols=4,
                                   sheet_rows=1, tile_size=12.0,
                                   origin=(-60.0, -40.0)))
    app = _app_2d(m, app_kw, 64, width, height, sp.SpritePlugin(),
                  gz.GizmosPlugin(capacity=64), tm)
    txt.spawn_digit_counter(app.world, font, num_digits=3,
                            pos=(-70.0, 45.0), size=10.0)
    app.add_systems(m["root"].Update,
                    txt.make_digit_system(font, "frame_count", "count"))
    app.world.spawn(sp.sprite_from_handle(frames[0], size=(24.0, 24.0)),
                    sp.AtlasAnimation(fps=7.0, first=0, count=4),
                    *tb(translation=(40.0, 20.0, 20.0)))
    app.add_systems(m["root"].Update, sp.make_atlas_animation_system(frames))
    app.world.spawn(gz.RetainedGizmo(a=(-70.0, -40.0, 0.0),
                                     b=(70.0, 40.0, 0.0), is3d=False))
    app.world.spawn(gz.RetainedGizmo(a=(-70.0, 40.0, 0.0),
                                     b=(0.0, -40.0, 0.0), width=4.0,
                                     color=(1.0, 0.5, 0.0, 0.7),
                                     is3d=False))
    app.insert_resource(m["tex"].TextureAtlas.RESOURCE,
                        {"data": _build_atlas(builder, app_kw)})
    return app


# ---------------------------------------------------------------------------
# 3D screen-pass worlds (post-processing, motion vectors, SSAA, fog, SSR):
# each built with the modules `m` (SCENE_MODULES of either package), app_kw
# for App and jax_kw for the JAX package's Mesh3dPlugin and
# DeferredLightingPlugin ({"backend": "pallas_interpret"}; {} for the
# port). Each runs its frames and returns (sRGB image (H, W, 4) int, app).


def _app_3d(m, app_kw, jax_kw, capacity, width, height, *plugins,
            deferred=False, ssaa=1, motion=False):
    """An App with time, transforms, the render target (`ssaa`), a
    Mesh3dPlugin (deferred, motion vectors) and `plugins` after it; the
    mesh plugin is app.mesh_plugin."""
    m3 = m["m3"]
    app = m["root"].App(capacity=capacity, **app_kw)
    kw = dict(jax_kw, deferred=True) if deferred else dict(jax_kw)
    if motion:
        kw["motion_vectors"] = True
    plugin = m3.Mesh3dPlugin(**kw)
    app.mesh_plugin = plugin
    return app, plugin, [m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                         m["render"].RenderPlugin(width=width, height=height,
                                                  ssaa=ssaa), plugin]


def _run(m, app, frames):
    for _ in range(frames):
        app.update(dt=1 / 60)
    return m["plug"].frame_image(app).astype(int), app


def post_world(m, app_kw, jax_kw, width=160, height=96):
    """examples/post_processing.py's scene (24 cubes, three emissive, a
    directional light) through SSAO, bloom, depth of field, CAS, FXAA and
    ACES tonemapping; one frame."""
    m3, tb, pp = m["m3"], m["tf"].transform_bundle, m["post"]
    app, plugin, plugins = _app_3d(m, app_kw, jax_kw, 64, width, height)
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    app.add_plugins(*plugins, pp.SsaoPlugin(intensity=1.5),
                    pp.BloomPlugin(threshold=0.8, intensity=0.35),
                    pp.DepthOfFieldPlugin(focal_distance=6.0,
                                          focal_range=3.0),
                    pp.CasPlugin(strength=0.5), pp.FxaaPlugin(),
                    pp.TonemappingPlugin())
    for i in range(24):
        x = (i % 6) - 2.5
        z = -(i // 6) * 3.0
        emissive = (2.0, 1.6, 0.4) if i % 7 == 0 else (0.0, 0.0, 0.0)
        app.world.spawn(
            m3.Mesh3d(mesh=cube),
            m3.MeshMaterial(base_color=(0.4 + 0.1 * (i % 5), 0.45, 0.6, 1.0),
                            emissive=emissive),
            *tb(translation=(x * 1.6, 0.0, z)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.2),
                    *tb(rotation=(-0.35, 0.25, 0.08, 0.9)))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 1.5, 6.0)))
    return _run(m, app, 1)


def aa_world(m, app_kw, jax_kw, mode, width=128, height=72, frames=None):
    """examples/anti_aliasing.py's scene (a turned cube, a directional
    light, ambient 0.3). mode "taa": per-object motion vectors and
    TaaPlugin, the cube and the camera drifting (+1.5 and -0.9 world
    units a second on every axis), 3 frames; "ssaa": RenderPlugin(ssaa=2),
    one frame; "fxaa", "cas", "smaa": that filter, one frame."""
    m3, tb, pp, q = m["m3"], m["tf"].transform_bundle, m["post"], m["root"]
    app, plugin, plugins = _app_3d(
        m, app_kw, jax_kw, 8, width, height, ssaa=2 if mode == "ssaa" else 1,
        motion=mode == "taa")
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    extra = {"taa": pp.TaaPlugin, "fxaa": pp.FxaaPlugin, "cas": pp.CasPlugin,
             "smaa": pp.SmaaPlugin}.get(mode)
    app.add_plugins(*plugins, *([extra()] if extra else []))
    app.insert_resource(m3.AmbientLight(brightness=0.3))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 1, 4)))
    app.world.spawn(m3.DirectionalLight(),
                    *tb(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(m3.Mesh3d(mesh=cube),
                    m3.MeshMaterial(base_color=(0.8, 0.7, 0.3, 1.0)),
                    *tb(rotation=(0.0, 0.31, 0.13, 0.94)))
    if mode == "taa":
        tf, Time = m["tf"].Transform, m["time"].Time

        @m["system"].system
        def drift_mesh(qm=q.Query(tf, q.With(m3.Mesh3d)), time=q.Res(Time)):
            qm.transform.translation = qm.transform.translation + \
                time.delta * 1.5

        @m["system"].system
        def drift_camera(qc=q.Query(tf, q.With(m["cam"].Camera3d)),
                         time=q.Res(Time)):
            qc.transform.translation = qc.transform.translation - \
                time.delta * 0.9

        app.add_systems(m["root"].Update, drift_mesh)
        app.add_systems(m["root"].Update, drift_camera)
    return _run(m, app, frames or (3 if mode == "taa" else 1))


def fog_world(m, app_kw, jax_kw, width=160, height=96):
    """examples/fog_3d.py's colonnade (16 cubes and a floor) through
    distance and volumetric fog; one frame."""
    m3, tb, fog = m["m3"], m["tf"].transform_bundle, m["fog"]
    app, plugin, plugins = _app_3d(m, app_kw, jax_kw, 64, width, height)
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    app.add_plugins(*plugins,
                    fog.DistanceFogPlugin(color=(0.35, 0.4, 0.5),
                                          density=0.05),
                    fog.VolumetricFogPlugin(density=0.04))
    app.insert_resource(m3.AmbientLight(brightness=0.15))
    for i in range(8):
        for sx in (-2.5, 2.5):
            app.world.spawn(
                m3.Mesh3d(mesh=cube),
                m3.MeshMaterial(base_color=(0.8, 0.3 + 0.08 * i, 0.2, 1.0)),
                *tb(translation=(sx, 0.0, -3.0 * i), scale=(1.0, 2.0, 1.0)))
    app.world.spawn(m3.Mesh3d(mesh=cube),
                    m3.MeshMaterial(base_color=(0.4, 0.42, 0.45, 1.0)),
                    *tb(translation=(0.0, -1.6, -12.0),
                        scale=(30.0, 0.2, 40.0)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.2),
                    *tb(rotation=(-0.35, 0.25, 0.0, 0.9)))
    app.world.spawn(m["cam"].Camera3d(), *tb(
        translation=(0.0, 1.5, 4.0), rotation=(-0.08, 0.0, 0.0, 0.997)))
    return _run(m, app, 1)


def ssr_world(m, app_kw, jax_kw, width=160, height=96):
    """examples/ssr_demo.py's scene: a glossy metallic floor reflecting a
    sphere, deferred, SsrPlugin(steps=24, stride=0.6, thickness=0.8); one
    frame."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    app, plugin, plugins = _app_3d(m, app_kw, jax_kw, 16, width, height,
                                   deferred=True)
    floor = plugin.add_mesh(m["mesh"].cuboid(8.0, 0.2, 6.0))
    sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.7, 20, 14))
    app.add_plugins(*plugins, m["deferred"].DeferredLightingPlugin(**jax_kw),
                    m["ssr"].SsrPlugin(steps=24, stride=0.6, thickness=0.8))
    app.insert_resource(m3.AmbientLight(brightness=0.25))
    app.world.spawn(m["cam"].Camera3d(),
                    *tb(translation=(0, 1.6, 5),
                        rotation=(-0.13, 0.0, 0.0, 0.991)))
    app.world.spawn(m3.DirectionalLight(),
                    *tb(rotation=(-0.4, 0.2, 0.0, 0.9)))
    app.world.spawn(m3.Mesh3d(mesh=floor),
                    m3.MeshMaterial(base_color=(0.35, 0.4, 0.45, 1.0),
                                    metallic=0.9, perceptual_roughness=0.15),
                    *tb(translation=(0.0, -0.6, 0.0)))
    app.world.spawn(m3.Mesh3d(mesh=sphere),
                    m3.MeshMaterial(base_color=(0.9, 0.4, 0.2, 1.0)),
                    *tb(translation=(0.0, 0.5, 0.0)))
    return _run(m, app, 1)


GOLDEN_SCENES.update({
    "post_f1": (post_world, ()),
    "taa_f3": (aa_world, ("taa",)),
    "ssaa2_f1": (aa_world, ("ssaa",)),
    "fog_f1": (fog_world, ()),
    "ssr_f1": (ssr_world, ()),
})


# ---------------------------------------------------------------------------
# Screen-pass inputs (numpy): the planes a screen pass reads, made from a
# seed, for the per-pass tests of both packages.

SCREEN_H, SCREEN_W = 50, 66      # not multiples of 4: bloom pads its tail
SCREEN_NEAR = 0.1


def screen_camera(frame=0):
    """Camera rows (2 rows, the first masked off): a camera at (0.2, 1.0,
    3.0) pitched down a little, drifting (+0.05, 0, -0.03) and turning a
    little each `frame`."""
    a = 0.06 + 0.01 * frame
    rot = np.array([-np.sin(a), 0.02 * frame, 0.0, np.cos(a)], np.float32)
    rot /= np.linalg.norm(rot)
    t = np.array([0.2 + 0.05 * frame, 1.0, 3.0 - 0.03 * frame], np.float32)
    return dict(
        mask=np.array([False, True]),
        translation=np.stack([np.array([9.0, -3.0, 1.0], np.float32), t]),
        rotation=np.stack([np.array([0.3, 0.1, 0.0, 0.95], np.float32),
                           rot]).astype(np.float32),
        scale=np.ones((2, 3), np.float32),
        fov=np.array([1.2, np.pi / 4], np.float32),
        near=np.array([0.5, SCREEN_NEAR], np.float32))


def screen_light():
    """Directional light rows (2 rows, the first masked off)."""
    rot = np.array([-0.35, 0.25, 0.08, 0.9], np.float32)
    rot /= np.linalg.norm(rot)
    return dict(mask=np.array([False, True]),
                rotation=np.stack([np.array([0.0, 0.0, 0.0, 1.0],
                                            np.float32), rot]),
                color=np.array([[0.0, 0.0, 1.0], [1.0, 0.95, 0.9]],
                               np.float32),
                illuminance=np.array([5.0, 1.3], np.float32))


def screen_planes(seed, h=SCREEN_H, w=SCREEN_W, gplanes=19):
    """A view of a floor (view-space y = -1) and a sphere, sky above the
    horizon: (colour (4, H, W) HDR, reverse-z depth (H, W) with ids in its
    low 7 mantissa bits, 0 on the sky, G-buffer (gplanes, H, W)) as f32
    numpy. Colour: flat per object with a checker on the floor, noise and
    a few bright (> 1) pixels; G-buffer: albedo, unit normals, emissive,
    metallic, roughness (some below 0.4), clearcoat, anisotropy,
    reflectance and, with 22 planes, a specular tint."""
    rng = np.random.RandomState(seed)
    f = 1.0 / np.tan(np.pi / 8)
    xs = ((np.arange(w) + 0.5) / w * 2 - 1) * (w / h) / f
    ys = (1 - (np.arange(h) + 0.5) / h * 2) / f
    dx = np.broadcast_to(xs[None, :], (h, w))
    dy = np.broadcast_to(ys[:, None], (h, w))
    zv = np.full((h, w), np.inf)
    obj = np.zeros((h, w), np.int32)              # 0 sky, 1 floor, 2 ball
    floor = dy < -0.02
    zv[floor] = np.minimum(1.0 / -dy[floor], 60.0)
    obj[floor] = 1
    # the sphere at view (0.3, -0.3, -3), radius 0.7: |t d - c|^2 = r^2
    c = np.array([0.3, -0.3, -3.0])
    d = np.stack([dx, dy, -np.ones_like(dx)], -1)
    a_ = np.sum(d * d, -1)
    b_ = -2 * np.sum(d * c, -1)
    c_ = c @ c - 0.49
    disc = b_ * b_ - 4 * a_ * c_
    hit = disc > 0
    t = np.where(hit, (-b_ - np.sqrt(np.maximum(disc, 0))) / (2 * a_),
                 np.inf)
    ball = hit & (t < zv)
    zv[ball] = t[ball]
    obj[ball] = 2
    depth = np.where(obj > 0, SCREEN_NEAR / zv, 0.0).astype(np.float32)
    ids = (np.arange(h)[:, None] * 7 + np.arange(w)[None, :] * 3) % 128
    bits = depth.view(np.uint32)
    depth = np.where(obj > 0, (bits & ~np.uint32(127)) | ids.astype(
        np.uint32), bits).view(np.float32)
    base = np.array([[0.35, 0.55, 0.85], [0.6, 0.6, 0.55],
                     [0.9, 0.35, 0.2]], np.float32)
    chk = ((np.arange(h)[:, None] // 6 + np.arange(w)[None, :] // 6) % 2)
    rgb = base[obj] * np.where((obj == 1) & (chk == 1), 0.4, 1.0)[..., None]
    rgb = rgb + rng.normal(0, 0.02, rgb.shape)
    bright = rng.uniform(size=(h, w)) < 0.03
    rgb[bright] *= 4.0
    color = np.concatenate([np.clip(rgb, 0, None).transpose(2, 0, 1),
                            np.ones((1, h, w))]).astype(np.float32)
    g = np.zeros((gplanes, h, w), np.float32)
    g[0:3] = (base[obj] * 0.9 + rng.uniform(0, 0.1, (h, w, 3))) \
        .transpose(2, 0, 1)
    g[3] = 1.0
    p = d * zv[..., None]
    nrm = np.where((obj == 2)[..., None], p - c, [0.0, 1.0, 0.0])
    nrm = nrm + rng.normal(0, 0.05, nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    g[4:7] = nrm.transpose(2, 0, 1)
    g[7:10] = rng.uniform(0, 0.05, (3, h, w))
    g[10] = np.where(obj == 1, 0.9, rng.uniform(0, 1, (h, w)))
    g[11] = np.where(obj == 1, rng.uniform(0.05, 0.3, (h, w)),
                     rng.uniform(0.2, 1.0, (h, w)))
    g[12:14] = rng.uniform(0, 0.3, (2, h, w))
    g[18] = 0.5
    if gplanes >= 22:
        g[19:22] = rng.uniform(0.3, 1.0, (3, h, w))
    g[:, obj == 0] = 0.0
    return color, depth, g


def screen_views(asarray, frame=0):
    """The camera and light query views of screen_camera(frame) and
    screen_light() as namespaces of `asarray` arrays (jnp.asarray or a
    torch constructor): what a screen pass's system reads."""
    from types import SimpleNamespace as ns
    c, li = screen_camera(frame), screen_light()
    cam = ns(mask=asarray(c["mask"]),
             global_transform=ns(translation=asarray(c["translation"]),
                                 rotation=asarray(c["rotation"]),
                                 scale=asarray(c["scale"])),
             camera3d=ns(fov=asarray(c["fov"]), near=asarray(c["near"])))
    light = ns(mask=asarray(li["mask"]),
               global_transform=ns(rotation=asarray(li["rotation"])),
               directional_light=ns(color=asarray(li["color"]),
                                    illuminance=asarray(li["illuminance"])))
    return cam, light


# ---------------------------------------------------------------------------
# A8's rest: cameras and viewports, OIT, transmission, custom materials,
# depth bias, two-phase occlusion, the BVH cull, LOD chains and the cluster
# DAG. Each builder takes the modules `m` (SCENE_MODULES of either
# package), app_kw for App (the port's {"device": ...}) and plugin_kw for
# Mesh3dPlugin (and TransmissionPlugin): the JAX package's backend. Each
# runs its frames and returns (sRGB image (H, W, 4) int, app); occl_world
# returns the list of its frames' images.

ROT_UP = (float(np.sin(np.pi / 4)), 0.0, 0.0, float(np.cos(np.pi / 4)))


def _a8_app(m, app_kw, capacity, width, height, plugin, *plugins):
    app = m["root"].App(capacity=capacity, **app_kw)
    app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                    m["render"].RenderPlugin(width=width, height=height),
                    plugin, *plugins)
    return app


def _look_at(eye):
    """xyzw quaternion turning -z toward the origin from `eye` (a yaw
    about +y, then a pitch about +x)."""
    ex, ey, ez = eye
    yaw = np.arctan2(ex, ez)
    pitch = -np.arctan2(ey, max(np.hypot(ex, ez), 1e-6))
    qy = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
    qx = np.array([np.sin(pitch / 2), 0.0, 0.0, np.cos(pitch / 2)])
    x1, y1, z1, w1 = qy
    x2, y2, z2, w2 = qx
    q = np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                  w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])
    return tuple(float(v) for v in q / np.linalg.norm(q))


def split_world(m, app_kw, plugin_kw, kind, width=160, height=96):
    """Cameras and viewports, one frame. "two": tests/test_viewport.py's
    two side-by-side cameras (order 0 on the left half at z 3, order 1 on
    the right half at z 6) over a red cube; "layers": the same with the
    right camera's RenderLayers 2, so its half stays clear although the
    left camera's cube reaches past the split; "four": examples/
    split_screen.py's four quarter viewports in `order` around a cube, a
    sphere and a ground plane."""
    m3, tb, cam = m["m3"], m["tf"].transform_bundle, m["cam"]
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    app = _a8_app(m, app_kw, 32, width, height, plugin)
    if kind == "four":
        cube = plugin.add_mesh(m["mesh"].cuboid(1.2, 1.2, 1.2))
        ball = plugin.add_mesh(m["mesh"].uv_sphere(0.8, 10, 14))
        ground = plugin.add_mesh(m["mesh"].plane(8.0, 8.0))
        views = [((0.0, 0.0), (0.5, 0.5), (0.0, 2.5, 6.0)),
                 ((0.5, 0.0), (1.0, 0.5), (6.0, 2.5, 0.0)),
                 ((0.0, 0.5), (0.5, 1.0), (0.0, 2.5, -6.0)),
                 ((0.5, 0.5), (1.0, 1.0), (-6.0, 2.5, 0.0))]
        # spawned out of order: the pass sorts by `order`
        for i in (2, 0, 3, 1):
            mn, mx, eye = views[i]
            app.world.spawn(cam.Camera3d(order=i, vp_min=mn, vp_max=mx),
                            *tb(translation=eye, rotation=_look_at(eye)))
        app.world.spawn(m3.Mesh3d(mesh=ground),
                        m3.MeshMaterial(base_color=(0.35, 0.6, 0.35, 1.0)),
                        *tb(translation=(0.0, -1.2, 0.0)))
        app.world.spawn(m3.Mesh3d(mesh=cube),
                        m3.MeshMaterial(base_color=(0.9, 0.25, 0.2, 1.0)),
                        *tb(rotation=(0.0, 0.38, 0.0, 0.925)))
        app.world.spawn(m3.Mesh3d(mesh=ball),
                        m3.MeshMaterial(base_color=(0.2, 0.35, 0.9, 1.0)),
                        *tb(translation=(1.8, 0.0, -1.0)))
        app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                        *tb(rotation=_look_at((2.0, 4.0, 3.0))))
    else:
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        app.world.spawn(cam.Camera3d(order=0, vp_min=(0.0, 0.0),
                                     vp_max=(0.5, 1.0)),
                        *tb(translation=(0.0, 0.0, 3.0)))
        app.world.spawn(cam.Camera3d(order=1, vp_min=(0.5, 0.0),
                                     vp_max=(1.0, 1.0),
                                     layers=2 if kind == "layers" else 1),
                        *tb(translation=(0.0, 0.0, 6.0)))
        app.world.spawn(m3.Mesh3d(mesh=cube),
                        m3.MeshMaterial(base_color=(1.0, 0.1, 0.1, 1.0)),
                        *tb(rotation=(0.1, 0.3, 0.0, 0.949)))
        app.world.spawn(m3.DirectionalLight(illuminance=1.0), *tb())
    return _run(m, app, 1)


def oit_world(m, app_kw, plugin_kw, kind, width=160, height=96):
    """Weighted-blended OIT, one frame. "panes": tests/test_oit.py's
    scene: an opaque backdrop, a red pane (alpha 0.5) at z 2 and a blue
    one at z 3 over it, and a red pane (alpha 0.9) behind the backdrop,
    which must not show; "blend": examples/blend_modes.py's spheres of
    alpha 1.0 (the opaque phase), 0.6 and 0.25 over a slab."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    app = _a8_app(m, app_kw, 32, width, height, plugin)
    if kind == "panes":
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 8.0)))
        app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                        *tb(rotation=(-0.38, 0.0, 0.0, 0.92)))
        app.world.spawn(m3.Mesh3d(mesh=cube),
                        m3.MeshMaterial(base_color=(0.9, 0.9, 0.9, 1.0)),
                        *tb(translation=(0.0, 0.0, -2.0),
                            scale=(10.0, 8.0, 0.5)))
        for color, pos in (((1.0, 0.1, 0.1, 0.5), (0.0, 0.0, 2.0)),
                           ((0.1, 0.1, 1.0, 0.5), (0.8, 0.4, 3.0)),
                           ((1.0, 0.1, 0.1, 0.9), (0.0, 0.0, -5.0))):
            app.world.spawn(m3.Mesh3d(mesh=cube),
                            m3.MeshMaterial(base_color=color),
                            *tb(translation=pos, scale=(3.0, 2.0, 0.1)))
    else:
        sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.6, 20, 14))
        slab = plugin.add_mesh(m["mesh"].cuboid(6.0, 0.2, 4.0))
        app.insert_resource(m3.AmbientLight(brightness=0.25))
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 1.2, 4)))
        app.world.spawn(m3.DirectionalLight(),
                        *tb(rotation=(-0.35, 0.0, 0.0, 0.94)))
        app.world.spawn(m3.Mesh3d(mesh=slab),
                        m3.MeshMaterial(base_color=(0.5, 0.5, 0.55, 1.0)),
                        *tb(translation=(0.0, -0.8, 0.0)))
        for x, a in ((-1.5, 1.0), (0.0, 0.6), (1.5, 0.25)):
            app.world.spawn(m3.Mesh3d(mesh=sphere),
                            m3.MeshMaterial(base_color=(0.9, 0.35, 0.2, a)),
                            *tb(translation=(x, 0.0, 0.0)))
    return _run(m, app, 1)


def glass_world(m, app_kw, plugin_kw, kind):
    """Specular and diffuse transmission (TransmissionPlugin), one frame.
    "tint": tests/test_transmission.py's red-tinted glass panel before a
    green wall (160x96); "volume": tests/test_volume_transmission.py's
    thick glass (thickness 2, attenuation distance 1, a green attenuation
    colour) before a white wall (160x96); "translucent": its panel with
    diffuse_transmission 1 lit only from behind (128x96)."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    back = kind == "translucent"
    app = _a8_app(m, app_kw, 32, 128 if back else 160, 96, plugin,
                  m["trans"].TransmissionPlugin(plugin, **plugin_kw))
    app.insert_resource(m3.AmbientLight(brightness=0.02 if back else 0.25))
    app.world.spawn(m["cam"].Camera3d(),
                    *tb(translation=(0, 0, 4 if back else 5)))
    if back:
        app.world.spawn(m3.DirectionalLight(illuminance=3.0),
                        *tb(rotation=(0.0, 1.0, 0.0, 0.0)))
        app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
            base_color=(0.9, 0.85, 0.7, 1.0), diffuse_transmission=1.0),
            *tb(scale=(2.0, 2.0, 0.1)))
        return _run(m, app, 1)
    app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                    *tb(rotation=(-0.3, 0.2, 0.0, 0.93)))
    wall = dict(base_color=(0.1, 0.9, 0.1, 1.0), emissive=(0.0, 0.4, 0.0)) \
        if kind == "tint" else dict(base_color=(0.9, 0.9, 0.9, 1.0),
                                    emissive=(0.5, 0.5, 0.5))
    app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(**wall),
                    *tb(translation=(0.0, 0.0, -2.0), scale=(8.0, 5.0, 0.2)))
    glass = dict(base_color=(1.0, 0.25, 0.25, 1.0)) if kind == "tint" \
        else dict(base_color=(1.0, 1.0, 1.0, 1.0), thickness=2.0,
                  attenuation_distance=1.0, attenuation_color=(0.2, 1.0, 0.2))
    app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
        specular_transmission=1.0, perceptual_roughness=0.05, ior=1.5,
        **glass), *tb(translation=(0.0, 0.0, 1.0), scale=(2.0, 2.0, 0.1)))
    return _run(m, app, 1)


def _xp(m):
    """The array namespace a material function of `m`'s package computes
    with (user shading code takes its package's arrays)."""
    return getattr(m["m3"], "jnp", None) or m["m3"].torch


def toon_material(xp):
    """tests/test_custom_material.py's two-band toon shading."""
    def fn(n, mat, ok, lv):
        d = -(n[..., 0] * lv[0] + n[..., 1] * lv[1] + n[..., 2] * lv[2])
        band = xp.where(d > 0.5, 1.0, xp.where(d > 0.1, 0.55, 0.18))
        return xp.concatenate([mat[..., 0:3] * band[..., None],
                               mat[..., 3:4]], -1)
    return fn


def quantize_extension(xp):
    """tests/test_extended_material.py's quantizing extension."""
    def fn(rgba, n, mat, ok, lv):
        return xp.concatenate([xp.round(rgba[..., :3] * 3.0) / 3.0,
                               rgba[..., 3:4]], -1)
    return fn


def shader_world(m, app_kw, plugin_kw, kind, width=128, height=96):
    """Custom materials (Mesh3dPlugin(material_fn=...)), one frame of a
    sphere: "toon" (toon_material), "quantize" (extended_material over
    quantize_extension), "identity" (extended_material with a
    pass-through extension), "standard" (no material_fn)."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    xp = _xp(m)
    fn = {"toon": lambda: toon_material(xp),
          "quantize": lambda: m3.extended_material(quantize_extension(xp)),
          "identity": lambda: m3.extended_material(
              lambda rgba, *a: rgba),
          "standard": lambda: None}[kind]()
    plugin = m3.Mesh3dPlugin(material_fn=fn, **plugin_kw)
    sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.9, 24, 16))
    app = _a8_app(m, app_kw, 8, width, height, plugin)
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 3)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                    *tb(rotation=(-0.3, 0.2, 0.0, 0.93)))
    app.world.spawn(m3.Mesh3d(mesh=sphere),
                    m3.MeshMaterial(base_color=(0.9, 0.4, 0.2, 1.0)),
                    *tb())
    return _run(m, app, 1)


def bias_world(m, app_kw, plugin_kw, bias, width=128, height=96):
    """tests/test_depth_bias_uvt.py's two exactly coplanar quads, red, then
    green with depth_bias `bias`; one frame."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    quad = plugin.add_mesh(m["mesh"].plane(2.0, 2.0))
    app = _a8_app(m, app_kw, 16, width, height, plugin)
    app.insert_resource(m3.AmbientLight(brightness=0.8))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 4)))
    app.world.spawn(m3.DirectionalLight(illuminance=0.3),
                    *tb(rotation=(-0.3, 0.2, 0.0, 0.93)))
    app.world.spawn(m3.Mesh3d(mesh=quad),
                    m3.MeshMaterial(base_color=(1.0, 0.1, 0.1, 1.0)),
                    *tb(rotation=ROT_UP))
    app.world.spawn(m3.Mesh3d(mesh=quad),
                    m3.MeshMaterial(base_color=(0.1, 1.0, 0.1, 1.0),
                                    depth_bias=bias), *tb(rotation=ROT_UP))
    return _run(m, app, 1)


def _cube_field(m, app_kw, plugin, n):
    """tests/test_occlusion.py's scene at 160x96: a near wall before `n`
    random cubes (seed 0), one camera, one light."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    app = _a8_app(m, app_kw, 256, 160, 96, plugin)
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 14.0)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                    *tb(rotation=(-0.38, 0.0, 0.0, 0.92)))
    rng = np.random.RandomState(0)
    app.world.spawn(m3.Mesh3d(mesh=cube),
                    m3.MeshMaterial(base_color=(0.3, 0.5, 0.8, 1.0)),
                    *tb(translation=(0.0, 0.0, 6.0), scale=(6.0, 4.0, 0.5)))
    for _ in range(n):
        app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
            base_color=tuple(float(c) for c in rng.uniform(0.2, 1.0, 3))
            + (1.0,)), *tb(translation=(
                float(rng.uniform(-12, 12)), float(rng.uniform(-7, 7)),
                float(rng.uniform(-12, 0)))))
    return app


def occl_world(m, app_kw, plugin_kw, occlusion, frames=3, n=120):
    """_cube_field with Mesh3dPlugin(occlusion_cull=occlusion,
    phase_budget=512); `frames` frames. Returns (the frames' images,
    app)."""
    app = _cube_field(m, app_kw, m["m3"].Mesh3dPlugin(
        occlusion_cull=occlusion, phase_budget=512, **plugin_kw), n)
    imgs = []
    for _ in range(frames):
        app.update(dt=1 / 60)
        imgs.append(m["plug"].frame_image(app).astype(int))
    return imgs, app


def budget_world(m, app_kw, plugin_kw, budget, n=120):
    """_cube_field without occlusion culling, one frame, with
    Mesh3dPlugin(visible_budget=budget): the visible clusters compacted
    to `budget` (the rest dropped, counted into pair_overflow)."""
    return _run(m, _cube_field(m, app_kw, m["m3"].Mesh3dPlugin(
        visible_budget=budget, **plugin_kw), n), 1)


def bvh_world(m, app_kw, plugin_kw, bvh, width=128, height=96):
    """tests/test_bvh_cull.py's integration scene: a sphere of 3,072
    triangles filling a close-up (128x96 there), part of it off screen,
    Mesh3dPlugin(bvh_cull=bvh); one frame."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(bvh_cull=bvh, **plugin_kw)
    mesh = plugin.add_mesh(m["mesh"].uv_sphere(2.0, 48, 32))
    app = _a8_app(m, app_kw, 16, width, height, plugin)
    app.insert_resource(m3.AmbientLight(brightness=0.3))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0.0, 0.0, 2.6)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                    *tb(rotation=(-0.3, 0.2, 0.0, 0.93)))
    app.world.spawn(m3.Mesh3d(mesh=mesh),
                    m3.MeshMaterial(base_color=(0.8, 0.5, 0.3, 1.0)), *tb())
    return _run(m, app, 1)


def lod_world(m, app_kw, plugin_kw, threshold, lods=3):
    """tests/test_meshlet_lod.py's scene: a near and a far sphere of one
    3-level LOD chain (add_mesh(lods=3)) at a `threshold` px screen error,
    160x120; one frame."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    mesh = plugin.add_mesh(m["mesh"].uv_sphere(0.8, 24, 16), lods=lods,
                           lod_threshold_px=threshold)
    app = _a8_app(m, app_kw, 64, 160, 120, plugin)
    app.insert_resource(m3.AmbientLight(brightness=0.1))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 4)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.5),
                    *tb(rotation=(-0.3, 0.2, 0.0, 0.93)))
    app.world.spawn(m3.Mesh3d(mesh=mesh), m3.MeshMaterial(
        base_color=(0.8, 0.3, 0.2, 1.0)), *tb((0.0, 0.0, 0.0)))
    app.world.spawn(m3.Mesh3d(mesh=mesh), m3.MeshMaterial(
        base_color=(0.2, 0.4, 0.9, 1.0)), *tb((1.5, 0.5, -30.0)))
    return _run(m, app, 1)


def dag_world(m, app_kw, plugin_kw, dag, dist=6.0, width=192, height=108):
    """tests/test_cluster_dag.py's hero sphere (48 x 24 sectors; 192x108
    there) through add_mesh_dag(threshold_px=2) (`dag`) or add_mesh; one
    frame."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    plugin = m3.Mesh3dPlugin(**plugin_kw)
    mesh = m["mesh"].uv_sphere(radius=1.0, sectors=48, stacks=24)
    mid = plugin.add_mesh_dag(mesh, threshold_px=2.0) if dag \
        else plugin.add_mesh(mesh)
    app = _a8_app(m, app_kw, 8, width, height, plugin)
    app.insert_resource(m3.AmbientLight(brightness=0.35))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0.0, 0.0, dist)))
    app.world.spawn(m3.DirectionalLight(illuminance=1.0), *tb())
    app.world.spawn(m3.Mesh3d(mesh=mid), m3.MeshMaterial(
        base_color=(0.8, 0.3, 0.2, 1.0)), *tb())
    return _run(m, app, 1)


A8_BUILDERS = (split_world, oit_world, glass_world, shader_world,
               bias_world, occl_world, budget_world, bvh_world, lod_world,
               dag_world)
A8_HELPERS = (_a8_app, _look_at, _xp, toon_material, quantize_extension,
              _run)
GOLDEN_SCENES.update({
    "smooth_srec": (shade_record_world, ("smooth",)),
    "split_two": (split_world, ("two",)),
    "split_layers": (split_world, ("layers",)),
    "split_four": (split_world, ("four",)),
    "oit_panes": (oit_world, ("panes",)),
    "oit_blend": (oit_world, ("blend",)),
    "glass_tint": (glass_world, ("tint",)),
    "glass_volume": (glass_world, ("volume",)),
    "glass_translucent": (glass_world, ("translucent",)),
    "shader_toon": (shader_world, ("toon",)),
    "shader_quantize": (shader_world, ("quantize",)),
    "bias_green": (bias_world, (1.0,)),
    "bias_red": (bias_world, (-1.0,)),
    "occl_f3": (occl_world, (True,)),
    "budget_64": (budget_world, (64,)),
    "bvh_f1": (bvh_world, (True,)),
    "lod_15": (lod_world, (1.5,)),
    "lod_coarse": (lod_world, (10000.0,)),
    "dag_f1": (dag_world, (True,)),
})
# the JAX route each stored output renders through: the split-screen
# worlds through the general route (backend="xla"; the JAX group route
# cannot render a viewport, ROADMAP C3), every other through the Pallas
# kernels in interpret mode
GOLDEN_BACKEND = {name: "xla" for name in ("split_two", "split_layers",
                                           "split_four")}
