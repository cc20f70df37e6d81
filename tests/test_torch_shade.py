"""bevy_tpu_torch deferred shading vs the JAX package: light binning, the
B3 deferred shade (its plain PyTorch version here; the kernel itself is
held against that on the card by chip_smoke.py), and the flat G-buffer
records and resolve.

The same inputs, made from a seed with numpy, go through the JAX function
and its port. The JAX shade runs its Pallas kernel in interpret mode
(`interpret=True`).

Tolerances: integer outputs and gathered records (bin_lights, the
G-buffer resolve, the G-buffer records but their normal) must be equal;
the records' normal, normalised with rsqrt, within 2 ulp (XLA's CPU rsqrt
and PyTorch's differ by an ulp in about a third of the cases, and the
product rounds once more). The shade agrees to rtol
1e-4 / atol 1e-5: both sides evaluate the same f32 expressions in the same
association order, but rsqrt, sqrt and division round differently in XLA
and PyTorch (an ulp or two) and XLA may fuse a multiply-add. The inputs
keep away from the two places where the function itself amplifies an ulp
past that tolerance: the GGX peak `a2 / (pi * den^2)` of a smooth surface
near noh = 1 (roughness is drawn from [0.4, 1]), and a light almost on the
shaded point, whose direction an ulp of world position turns (the
surfaces lie on the plane y = 0, the lights at y >= 0.5).

The many_lights slice end to end, at the end of this file: the
bevy_tpu_torch twin (examples/torch_many_lights.py) on the CPU, where
every kernel wrapper runs its plain PyTorch version.

- The golden configuration of tests/test_goldens.py::test_golden_lights
  against the image the JAX package's Pallas path locked in
  tests/goldens/lights_f1.png (rendering that scene live through JAX in
  interpret mode takes about a minute on a CPU, so the stored golden
  stands in for it). Golden rule of tests/test_goldens.py: under 1% of
  pixels may drift by more than 8 in any channel.
- The JAX many_lights world carries across to the port column for column.
- The three behaviours of tests/test_lights.py, at that file's size.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bevy_tpu.ops import raster3d_visbuf as jvis
from bevy_tpu.ops import shade_pallas as jshade

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops import raster3d_visbuf as tvis
from bevy_tpu_torch.ops import shade as tshade

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_tpu_torch.interop import state_from_numpy  # noqa: E402
from bevy_tpu_torch.render.plugin import frame_image  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "goldens" / "lights_f1.png"
GOLDEN_KW = dict(n_lights=48, n_cubes=16, width=256, height=144,
                 capacity=256, camera=(0.0, 9.0, 22.0))

H, W = 64, 256          # 2 x 2 bin tiles of 32 x 128
MPT = 128               # light slots a tile (the JAX kernel's SMEM width)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------------------
# bin_lights


def _bin_inputs(seed=0, n=200, ntx=5, nty=3, tile_w=128, tile_h=32):
    """~200 lights over a 5 x 3 tile grid: some offscreen, some inactive,
    some with radii spanning many tiles, and a crowd in tile (1, 2)."""
    rng = np.random.RandomState(seed)
    w, h = ntx * tile_w, nty * tile_h
    cx = rng.uniform(-0.3 * w, 1.3 * w, n)
    cy = rng.uniform(-0.3 * h, 1.3 * h, n)
    r = rng.exponential(40.0, n)
    r[:10] = rng.uniform(200.0, 900.0, 10)          # many tiles each
    crowd = slice(10, 70)                            # all inside one tile
    cx[crowd] = rng.uniform(2 * tile_w + 10, 3 * tile_w - 10, 60)
    cy[crowd] = rng.uniform(tile_h + 5, 2 * tile_h - 5, 60)
    r[crowd] = 3.0
    active = rng.uniform(size=n) > 0.15
    records = rng.uniform(-5.0, 5.0, (n, 8)).astype(np.float32)
    vz = rng.uniform(1.0, 50.0, n).astype(np.float32)
    center = np.stack([cx, cy], 1).astype(np.float32)
    return vz, center, r.astype(np.float32), active, records


@pytest.mark.parametrize("ppl,mpt", [(4, 48), (1, 16)],
                         ids=["tile_overflow", "pair_overflow"])
def test_bin_lights_matches_jax(ppl, mpt):
    vz, center, r, active, records = _bin_inputs()
    args = dict(nty=3, ntx=5, tile_h=32, tile_w=128, pairs_per_light=ppl,
                max_per_tile=mpt)
    jt, jc, js = jshade.bin_lights(jnp.asarray(vz), jnp.asarray(center),
                                   jnp.asarray(r), jnp.asarray(active),
                                   records=jnp.asarray(records), **args)
    tt, tc, ts = tshade.bin_lights(center_px=T(center), radius_px=T(r),
                                   active=T(active), records=T(records),
                                   **args)
    assert tt.shape == (15, 8, mpt) and tc.dtype == torch.int32
    assert np.array_equal(N(jc), N(tc))
    assert np.array_equal(N(jt), N(tt))
    for k in ("light_pair_overflow", "light_tile_overflow"):
        assert int(js[k]) == int(ts[k]), k
    assert int(ts["light_tile_overflow"]) > 0
    if ppl == 1:
        assert int(ts["light_pair_overflow"]) > 0


# --------------------------------------------------------------------------
# deferred_shade


def _camera(width, height, eye=(0.0, 6.0, 12.0), fov=0.9, near=0.1):
    """inv_vp (4, 4) f32, the eye and the reverse-z depth (H, W) of the
    plane y = 0 seen by a camera looking at the origin (infinite far),
    in float64 then rounded."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = right, up, -fwd
    view[:3, 3] = -view[:3, :3] @ eye
    f = 1.0 / np.tan(fov / 2)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / (width / height), f
    proj[2, 3], proj[3, 2] = near, -1.0
    inv_vp = np.linalg.inv(proj @ view)
    px = np.arange(width) + 0.5
    py = np.arange(height)[:, None] + 0.5
    ndc = np.stack(np.broadcast_arrays(2 * px / width - 1,
                                       1 - 2 * py / height, 1.0, 1.0), -1)
    pn = ndc @ inv_vp.T
    ray = pn[..., :3] / pn[..., 3:] - eye
    hit = eye - ray * (eye[1] / ray[..., 1:2])
    zv = -(hit @ view[2, :3] + view[2, 3])
    depth = np.where(ray[..., 1] < 0, near / zv, 0.0)
    return inv_vp.astype(np.float32), eye, depth.astype(np.float32)


def _shade_inputs(seed, nplanes, nf, spot, rect, with_shadow):
    """A 64 x 256 G-buffer of the plane y = 0 with sky pixels (tile (0, 1)
    all sky), unit normals, roughness in [0.4, 1], and a light list of up
    to 20 lights a tile at y >= 0.5, some missing the tile's frustum."""
    rng = np.random.RandomState(seed)
    inv_vp, eye, depth = _camera(W, H)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    depth[0:32, 128:256] = 0.0
    g = rng.uniform(0.0, 1.0, (nplanes, H, W)).astype(np.float32)
    n = rng.normal(size=(3, H, W))
    g[4:7] = n / np.linalg.norm(n, axis=0)
    g[7:10] *= 0.1                                   # emissive
    g[11] = rng.uniform(0.4, 1.0, (H, W))            # roughness
    g[13] = rng.uniform(0.4, 1.0, (H, W))            # clearcoat roughness
    t = rng.normal(size=(3, H, W))
    t *= rng.uniform(0.2, 1.5, (1, H, W))            # some below 0.5: fallback
    g[14:17] = t
    g[17] *= 0.9                                     # anisotropy strength
    g[18] = rng.uniform(0.0, 1.0, (H, W))            # reflectance
    nt = 4
    table = np.zeros((nt, nf, MPT), np.float32)
    counts = rng.randint(5, 21, nt).astype(np.int32)
    for tt in range(nt):
        k = MPT
        rec = np.zeros((k, nf), np.float32)
        rec[:, 0:3] = rng.uniform([-8, 0.5, -8], [8, 3, 8], (k, 3))
        rec[:, 3:6] = rng.uniform(0.2, 3.0, (k, 3))
        rec[:, 6] = rng.uniform(2.0, 9.0, k)
        if nf >= 16:
            d = rng.normal(size=(k, 3))
            rec[:, 8:11] = d / np.linalg.norm(d, axis=1, keepdims=True)
            co = np.cos(rng.uniform(0.3, 1.2, k))
            ci = np.cos(rng.uniform(0.05, 0.25, k))
            rec[:, 11] = co
            rec[:, 12] = 1.0 / np.maximum(ci - co, 1e-4)
            if spot:                                 # half are points
                pts = rng.uniform(size=k) < 0.5
                rec[pts, 8:11] = 0.0
                rec[pts, 11], rec[pts, 12] = -2.0, 1.0
        if nf >= 24:
            is_rect = rng.uniform(size=k) < 0.6
            rec[is_rect, 15] = 1.0
            u = rng.normal(size=(k, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            v = np.cross(rec[:, 8:11], u)
            v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-6)
            rec[:, 16:19] = np.where(is_rect[:, None], u, 0.0)
            rec[:, 19:22] = np.where(is_rect[:, None], v, 0.0)
            rec[:, 22] = np.where(is_rect, rng.uniform(0.2, 1.5, k), 0.0)
            rec[:, 23] = np.where(is_rect, rng.uniform(0.2, 1.5, k), 0.0)
        table[tt] = rec.T
    ldir = np.asarray([0.3, -0.8, -0.5])
    ldir /= np.linalg.norm(ldir)
    params = np.concatenate([
        inv_vp.reshape(16), ldir, [1.0, 0.95, 0.9], [0.05, 0.05, 0.06],
        [W, H], [0.1, 0.1, 0.13, 1.0], eye, np.zeros(6)]).astype(np.float32)
    shadow = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32) \
        if with_shadow else None
    return g, depth, table, counts, params, shadow


VARIANT_CASES = {
    "point": dict(nf=8, nplanes=19, flags=dict(spot=False, clearcoat=False)),
    "spot": dict(nf=16, nplanes=19, flags=dict(spot=True, clearcoat=False)),
    "rect": dict(nf=24, nplanes=19, flags=dict(spot=True, rect=True,
                                               clearcoat=False)),
    "clearcoat_reflectance": dict(nf=8, nplanes=19, flags=dict(
        spot=False, clearcoat=True, reflectance=True)),
    "anisotropy": dict(nf=16, nplanes=19, flags=dict(
        spot=True, clearcoat=False, anisotropy=True)),
    "specular_tint": dict(nf=8, nplanes=22, flags=dict(
        spot=False, clearcoat=True, specular_tint=True)),
}


@pytest.mark.parametrize("shadow", [False, True], ids=["lit", "shadow"])
@pytest.mark.parametrize("variant", list(VARIANT_CASES))
def test_deferred_shade_plain_matches_pallas(variant, shadow):
    case = VARIANT_CASES[variant]
    flags = case["flags"]
    g, depth, table, counts, params, sh = _shade_inputs(
        7, case["nplanes"], case["nf"], flags.get("spot", False),
        flags.get("rect", False), shadow)
    # the JAX wrapper shades "no shadow" with a plane of ones
    # (shade_pallas.py:423); passing that plane itself lets the lit and
    # shadowed cases share one interpret-mode compile per variant
    jsh = np.ones((H, W), np.float32) if sh is None else sh
    want = np.asarray(jshade.deferred_shade(
        jnp.asarray(g), jnp.asarray(depth), jnp.asarray(table),
        jnp.asarray(counts), jnp.asarray(params), jnp.asarray(jsh),
        tile_h=32, tile_w=128, max_per_tile=MPT, interpret=True, **flags))
    got = N(tshade.deferred_shade(T(g), T(depth), T(table), T(counts),
                                  T(params), None if sh is None else T(sh),
                                  tile_h=32, tile_w=128, **flags))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    geom = depth > 0
    assert np.array_equal(got[:, ~geom], np.broadcast_to(
        params[27:31, None], (4, int((~geom).sum()))))
    # the light walk is not a no-op: without it the pixels are darker
    dark = N(tshade.deferred_shade(T(g), T(depth), T(table),
                                   torch.zeros(4, dtype=torch.int32),
                                   T(params), None if sh is None else T(sh),
                                   tile_h=32, tile_w=128, **flags))
    assert (got[:3, geom] - dark[:3, geom]).max() > 0.1


def test_side_plane_skip_is_exercised():
    """The shade inputs hold lights that miss their tile's sub-frustum
    (the reference's early skip) and lights that do not."""
    g, depth, table, counts, params, _ = _shade_inputs(7, 19, 8, False,
                                                       False, False)
    planes = tshade.tile_side_planes(T(params), 2, 2, 32, 128)
    inside = torch.stack([tshade.light_in_tile(planes, T(table)[:, :, s],
                                               T(params))
                          for s in range(int(counts.max()))], 1)
    live = torch.arange(inside.shape[1])[None, :] < T(counts)[:, None]
    assert bool((inside & live).any()) and bool((~inside & live).any())


CULL_CASES = {"point": 0, "spot": 0, "clearcoat_reflectance": 0,
              "anisotropy": 0, "specular_tint": 0, "point_band": 32}


def _cull_inputs(case):
    """The shade inputs of `case` (a variant, or "point_band": the point
    variant's bottom tile row shaded as a band, params[34] = 32)."""
    band = CULL_CASES[case]
    vc = VARIANT_CASES[case.replace("_band", "")]
    flags = vc["flags"]
    g, depth, table, counts, params, _ = _shade_inputs(
        7, vc["nplanes"], vc["nf"], flags.get("spot", False), False, False)
    if band:
        g, depth = g[:, band:], depth[band:]
        table, counts = table[2:], counts[2:]
        params = params.copy()
        params[34] = band
    return (T(np.ascontiguousarray(g)), T(np.ascontiguousarray(depth)),
            T(table), T(counts), T(params), flags)


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_light_in_block_drops_only_zero_terms(case):
    """B3's per-block cull (light_in_block) is exact: every (block, listed
    light) pair it drops that the reference's tile test keeps has win ==
    0.0 on every geometry pixel of the block; and the plain version with
    each block's list cut to the kept lights (order kept) shades that
    block bit for bit as the plain version with the whole list does."""
    g, depth, table, counts, params, flags = _cull_inputs(case)
    kw = dict(tile_h=32, tile_w=128)
    keep = tshade.light_in_block(depth, table, counts, params, **kw)
    nt, nby, nbx, ns = keep.shape
    assert (nby, nbx) == (2, 8) and ns == int(counts.max())
    dep, wx, wy, wz = tshade.tile_world_positions(depth, params, **kw)
    B = tshade.BLOCK
    geom = (dep > 0).reshape(nt, nby, B, nbx, B)
    planes = tshade.tile_side_planes(params, nt // 2, 2, 32, 128)
    dropped = kept = 0
    for s in range(ns):
        rec = table[:, :, s]
        walked = (s < counts) & tshade.light_in_tile(planes, rec, params)
        win = tshade.light_win(rec, wx, wy, wz).reshape(geom.shape)
        lit = ((win > 0) & geom).any(4).any(2)              # (T, nby, nbx)
        drop = walked[:, None, None] & ~keep[..., s] & geom.any(4).any(2)
        assert not (drop & lit).any(), s
        assert not (keep[..., s] & ~walked[:, None, None]).any()
        dropped += int(drop.sum())
        kept += int(keep[..., s].sum())
    assert dropped > 0 and kept > 0, (dropped, kept)

    full = tshade._deferred_shade_plain(g, depth, table, counts, params,
                                        **kw, **flags)
    yy = (torch.arange(depth.shape[0]) % 32) // B
    xx = (torch.arange(depth.shape[1]) % 128) // B
    for by in range(nby):
        for bx in range(nbx):
            k = keep[:, by, bx]                            # (T, S)
            order = torch.argsort((~k).to(torch.int8), dim=1, stable=True)
            cut = torch.cat([torch.gather(
                table[:, :, :ns], 2,
                order[:, None, :].expand(-1, table.shape[1], -1)),
                table[:, :, ns:]], 2)
            out = tshade._deferred_shade_plain(
                g, depth, cut.contiguous(), k.sum(1).to(torch.int32),
                params, **kw, **flags)
            m = (yy[:, None] == by) & (xx[None, :] == bx)
            assert torch.equal(out[:, m].view(torch.int32),
                               full[:, m].view(torch.int32)), (by, bx)


def test_shade_wrapper_on_cpu_launches_nothing():
    """CPU tensors run the plain version: no launch, nothing built."""
    tshade.deferred_shade.launches = 0
    g, depth, table, counts, params, _ = _shade_inputs(3, 19, 8, False,
                                                       False, False)
    out = tshade.deferred_shade(T(g), T(depth), T(table), T(counts),
                                T(params), spot=False)
    plain = tshade._deferred_shade_plain(T(g), T(depth), T(table),
                                         T(counts), T(params), spot=False)
    assert torch.equal(out, plain) and out.shape == (4, H, W)
    assert tshade.deferred_shade.launches == 0
    assert _cuda._Loaded.lib is None


# --------------------------------------------------------------------------
# flat G-buffer records and resolve


@pytest.mark.parametrize("ncols", [9, 15, 18])
def test_pack_flat_gbuf_matches_jax(ncols):
    rng = np.random.RandomState(2)
    cn = np.repeat(rng.normal(size=(30, 12, 1, 3)), 3, 2).astype(np.float32)
    mat = rng.uniform(0.0, 1.0, (30, 12, ncols)).astype(np.float32)
    valid = rng.uniform(size=(30, 12)) < 0.8
    want = np.asarray(jvis.pack_flat_gbuf(jnp.asarray(cn), jnp.asarray(mat),
                                          jnp.asarray(valid)))
    got = N(tvis.pack_flat_gbuf(T(cn), T(mat), T(valid)))
    assert got.shape == want.shape == (30, 12, 24 if ncols >= 18 else 16)
    rest = np.r_[0:4, 7:got.shape[-1]]
    assert np.array_equal(got[..., rest], want[..., rest])
    np.testing.assert_array_max_ulp(got[..., 4:7], want[..., 4:7], maxulp=2)


@pytest.mark.parametrize("nplanes", [19, 22])
def test_resolve_gbuf_flat_matches_jax(nplanes):
    rng = np.random.RandomState(4)
    frec = rng.uniform(0.0, 1.0, (50, 16)).astype(np.float32)
    winner = rng.randint(-1, 50, (H, W)).astype(np.int32)
    gbuf = rng.uniform(0.0, 1.0, (nplanes, H, W)).astype(np.float32)
    want = np.asarray(jvis.resolve_gbuf_flat(
        jnp.asarray(winner), jnp.asarray(frec), jnp.asarray(gbuf)))
    out = tvis.resolve_gbuf_flat(T(winner), T(frec), T(gbuf))
    assert out.is_contiguous()          # B3 takes only contiguous planes
    got = N(out)
    assert np.array_equal(got, want)
    hit = winner >= 0
    assert np.array_equal(got[18][hit], frec[winner[hit], 15])


def test_resolve_gbuf_flat_writes_tint_planes():
    """24-wide tinted records fill planes 19:22 of a 22-plane G-buffer
    (the JAX twin's concatenation raises on that shape, see ROADMAP C3)."""
    rng = np.random.RandomState(5)
    frec = rng.uniform(0.0, 1.0, (50, 24)).astype(np.float32)
    winner = rng.randint(-1, 50, (H, W)).astype(np.int32)
    gbuf = rng.uniform(0.0, 1.0, (22, H, W)).astype(np.float32)
    got = N(tvis.resolve_gbuf_flat(T(winner), T(frec), T(gbuf)))
    hit = winner >= 0
    assert np.array_equal(got[19:22][:, hit], frec[winner[hit], 16:19].T)
    assert np.array_equal(got[:, ~hit], gbuf[:, ~hit])
    ref16 = N(tvis.resolve_gbuf_flat(T(winner), T(frec[:, :16]), T(gbuf)))
    assert np.array_equal(got[:19], ref16[:19])


# --------------------------------------------------------------------------
# the many_lights slice end to end


def test_torch_many_lights_matches_golden():
    from PIL import Image

    import torch_many_lights

    app = torch_many_lights.build_app(device="cpu", **GOLDEN_KW)
    app.update(dt=1 / 60)
    img = frame_image(app).astype(int)
    golden = np.asarray(Image.open(GOLDEN)).astype(int)
    assert img.shape == golden.shape
    diff = np.abs(golden - img).max(-1)
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    stats = app.world.state["res"]["render_stats"]
    for k in ("pair_overflow", "tile_overflow", "light_pair_overflow",
              "light_tile_overflow"):
        assert int(stats[k]) == 0, k
    target = app.world.state["res"]["render_target"]
    assert target["gbuffer"].shape == (19, 144, 256)
    assert target["gbuffer"].is_contiguous()
    assert torch.isfinite(target["gbuffer"]).all()
    assert (target["depth"] > 0).float().mean() > 0.3


def test_state_from_numpy_carries_the_many_lights_world():
    """The JAX many_lights world (build_app renders nothing) converted with
    state_from_numpy holds every column and resource of the torch twin's
    world, with the same dtypes: PointLight, the 19-plane G-buffer and
    render_stats included."""
    import many_lights
    import torch_many_lights

    japp = many_lights.build_app(backend="pallas_interpret", **GOLDEN_KW)
    tapp = torch_many_lights.build_app(device="cpu", **GOLDEN_KW)
    state = state_from_numpy(jax.device_get(japp.world.state), "cpu")
    tstate = tapp.world.state
    assert {"point_light", "spot_light", "rect_light"} <= set(tstate["comp"])
    assert set(tstate["comp"]) <= set(state["comp"])
    for name, store in tstate["comp"].items():
        for key in ("has", "added", "changed", "removed"):
            assert torch.equal(state["comp"][name][key] > 0,
                               store[key] > 0), (name, key)
        for f, col in store["f"].items():
            got = state["comp"][name]["f"][f]
            assert got.dtype == col.dtype, (name, f)
            assert torch.equal(got, col), (name, f)
    missing = []
    for name, store in tstate["res"].items():
        for f, v in store.items():
            if f not in state["res"][name]:
                missing.append((name, f))
                continue
            got = state["res"][name][f]
            assert got.dtype == v.dtype and torch.equal(got, v), (name, f)
    assert tstate["res"]["render_target"]["gbuffer"].shape == (19, 144, 256)
    # the port's own counters: clusters routed to B2, and the light part
    # of the shared overflow counters
    assert sorted(missing) == [("render_stats", "fallback_clusters"),
                               ("render_stats", "light_pair_overflow"),
                               ("render_stats", "light_tile_overflow")]
    assert torch.equal(state["ent"]["alive"], tstate["ent"]["alive"])


# -- tests/test_lights.py's behaviours on the port ------------------------


def _frame(**kw):
    import torch_many_lights

    kw = dict(dict(n_lights=32, n_cubes=9, width=192, height=96,
                   capacity=128, camera=(0.0, 8.0, 20.0)), **kw)
    app = torch_many_lights.build_app(device="cpu", **kw)
    app.update(dt=1 / 60)
    return frame_image(app)


def _saturated(img):
    rgb = img[..., :3].astype(int)
    return int(((rgb.max(-1) - rgb.min(-1)) > 30).sum())


def test_floor_and_light_pools_render():
    img = _frame()
    h = img.shape[0]
    # the floor fills the lower view: pixels differ from the clear colour
    clear = np.asarray([88, 88, 102])
    lower = img[int(h * 0.7):, :, :3].astype(int)
    assert (np.abs(lower - clear).sum(-1) > 20).mean() > 0.9
    # some pixels are clearly lit by tinted point lights
    rgb = img[..., :3].astype(int)
    assert ((rgb.max(-1) - rgb.min(-1)) > 25).sum() > 20


def test_light_range_limits_pool():
    assert _saturated(_frame(light_range=2.0)) < \
        _saturated(_frame(light_range=10.0))


def test_no_lights_leaves_ambient_only():
    assert _saturated(_frame(n_lights=0)) < 10


def test_deferred_plugin_refuses_unported_features():
    """Transmission and depth bias (A8's rest, ported) in a deferred world
    render: a transmissive row leaves the opaque G-buffer pass (the
    transmission pass draws it, as in the JAX package), a biased row
    draws; several cameras or a viewport raise, naming ROADMAP C3 (the
    JAX package's deferred shade reads the first camera only); sharded
    shading over more CUDA cards than exist raises instead of falling
    back to fewer or the CPU. Specular tint and anisotropy (A4b, ported)
    render: tests/test_torch_shadow.py."""
    from bevy_tpu_torch.render.camera import Camera3d
    import torch_many_lights
    from bevy_tpu_torch.render.deferred import DeferredLightingPlugin
    from bevy_tpu_torch.render.mesh3d import Mesh3d, MeshMaterial
    from bevy_tpu_torch.transform import transform_bundle

    with pytest.raises(ValueError, match="devices"):
        DeferredLightingPlugin(shards=torch.cuda.device_count() + 1)
    for values in ({"specular_transmission": 0.5}, {"depth_bias": 1.0}):
        app = torch_many_lights.build_app(device="cpu", n_lights=4,
                                          n_cubes=1, width=128, height=64,
                                          capacity=16)
        app.world.spawn(Mesh3d(mesh=0), MeshMaterial(**values),
                        *transform_bundle())
        app.update(dt=1 / 60)
        assert (app.world.state["res"]["render_target"]["depth"] > 0).any()
    app.world.spawn(Camera3d(vp_max=(0.5, 1.0)), *transform_bundle())
    with pytest.raises(NotImplementedError, match="C3"):
        app.update(dt=1 / 60)
