"""Smoke run of the bevy_tpu_torch main path on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from `bevy_tpu_torch/csrc/`, then:
1. holds the window-splat (B1) and streaming-tile (B2) kernels against
   their plain PyTorch versions, bit for bit, on a scene with both window
   classes and on one with giant and near-plane clusters;
2. renders the many_cubes twin at the golden configuration (300 cubes,
   320x180, 2 frames) and compares it with tests/goldens/cubes_splat_f2.png
   (under 1% of pixels may drift by more than 8);
3. runs the full-size many_cubes frame (160,000 cubes, 1280x720), times 20
   frames with CUDA events and checks both kernels were launched;
4. times each kernel against its plain version at the full-size shapes.

The last two lines of standard output are a JSON object of kernel results
and the card's result line. Any failure raises; there is no CPU fallback.
"""

from __future__ import annotations

import json
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
KERNELS = {
    "B1": ("fused_eval_composite", "bevy_tpu_torch/csrc/splat_raster.cu",
           "bevy_tpu/ops/raster3d_splat.py:589"),
    "B2": ("raster_visbuf", "bevy_tpu_torch/csrc/stream_raster.cu",
           "bevy_tpu/ops/raster3d_visbuf.py:382"),
}


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
    """Wraps the mesh pass's two kernel entry points to keep the arguments
    of every call (for the kernel-vs-plain comparisons)."""

    def __init__(self, mesh3d):
        self.mesh3d = mesh3d
        self.calls = {"B1": [], "B2": []}
        self.orig = {"B1": mesh3d.fused_eval_composite,
                     "B2": mesh3d.raster_visbuf}

    def __enter__(self):
        for kid, fn in self.orig.items():
            def rec(*a, _k=kid, _f=fn, **kw):
                self.calls[_k].append((a, kw))
                return _f(*a, **kw)
            setattr(self.mesh3d, KERNELS[kid][0], rec)
        return self

    def __exit__(self, *exc):
        for kid, fn in self.orig.items():
            setattr(self.mesh3d, KERNELS[kid][0], fn)


def plain_fn(kid):
    from bevy_tpu_torch.ops import raster3d_splat, raster3d_visbuf
    return {"B1": raster3d_splat._fused_plain,
            "B2": raster3d_visbuf._raster_visbuf_plain}[kid]


def kernel_fn(kid):
    from bevy_tpu_torch.ops import raster3d_splat, raster3d_visbuf
    return {"B1": raster3d_splat.fused_eval_composite,
            "B2": raster3d_visbuf.raster_visbuf}[kid]


def compare(kid, a, kw):
    """Kernel vs plain on one recorded call; asserts bit equality of depth
    and winner, returns the max abs error."""
    dk, wk = kernel_fn(kid)(*a, **kw)
    dp, wp = plain_fn(kid)(*a, **kw)
    torch.cuda.synchronize()
    err = max(float((dk - dp).abs().max()), float((wk - wp).abs().max()))
    same = torch.equal(dk.view(torch.int32), dp.view(torch.int32)) and \
        torch.equal(wk.view(torch.int32), wp.view(torch.int32))
    if not same:
        nd = int((dk.view(torch.int32) != dp.view(torch.int32)).sum())
        nw = int((wk.view(torch.int32) != wp.view(torch.int32)).sum())
        raise AssertionError(f"{kid} kernel != plain: {nd} depth and {nw} "
                             f"winner pixels differ (max abs err {err})")
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false "
                         "— this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_many_cubes
    from bevy_tpu_torch.ops import _cuda, raster3d_splat, raster3d_visbuf
    from bevy_tpu_torch.render import frame_image, mesh3d

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
    for ln in _cuda._Loaded.ptxas_log.splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            log("  ptxas:", ln.strip())

    # -- kernels vs plain, golden scene and near-plane scene ------------
    golden_app = torch_many_cubes.build_app(
        n_cubes=300, width=320, height=180, capacity=512,
        window_budget=4096, device=dev)
    with Recorder(mesh3d) as rec_golden:
        golden_app.run(max_frames=2, dt=1 / 60)
    near_app = near_plane_app(dev)
    with Recorder(mesh3d) as rec_near:
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
    log(f"near-plane scene: {b2_lists} (tile, cluster) entries through B2")
    torch.cuda.synchronize()

    # -- golden image --------------------------------------------------
    img = frame_image(golden_app).astype(int)
    golden = read_png_rgba8(GOLDEN)
    if img.shape != golden.shape:
        raise AssertionError(f"golden shape {golden.shape} != {img.shape}")
    diff = np.abs(golden - img).max(-1)
    frac = float((diff > 8).mean())
    log(f"golden cubes_splat_f2: {frac:.4%} of pixels drift > 8 "
        f"(max channel diff {diff.max()})")
    if frac >= 0.01:
        raise AssertionError("golden cubes_splat_f2 failed")
    torch.cuda.synchronize()

    # -- full size: 160k cubes at 1280x720 -----------------------------
    app = torch_many_cubes.build_app(device=dev)
    step = app.frame_fn()
    state = app.world.state
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    stats0 = {k: int(v) for k, v in state["res"]["render_stats"].items()}
    n = 20
    raster3d_splat.fused_eval_composite.launches = 0
    raster3d_visbuf.raster_visbuf.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    launches = {"B1": raster3d_splat.fused_eval_composite.launches,
                "B2": raster3d_visbuf.raster_visbuf.launches}
    ms = start.elapsed_time(end) / n
    stats = {k: int(v) - stats0[k]
             for k, v in state["res"]["render_stats"].items()}
    color = state["res"]["render_target"]["color"]
    depth = state["res"]["render_target"]["depth"]
    if not (torch.isfinite(color).all() and torch.isfinite(depth).all()):
        raise AssertionError("full-size frame is not finite")
    covered = float((depth > 0).float().mean())
    log(f"many_cubes 160000 @1280x720: {ms:.3f} ms/frame over {n} frames "
        f"(CUDA events; {smi})")
    log(f"launches in those {n} frames: B1 {launches['B1']}, "
        f"B2 {launches['B2']}; fallback clusters to B2 "
        f"{stats['fallback_clusters'] / n:.1f}/frame; pair_overflow "
        f"{stats['pair_overflow']}, tile_overflow {stats['tile_overflow']}; "
        f"covered pixels {covered:.3f}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if stats["fallback_clusters"] == 0:
        raise AssertionError("no fallback cluster reached B2 at full size")
    if covered < 0.05:
        raise AssertionError("full-size frame drew (almost) nothing")

    # -- per kernel at the full-size shapes: parity + time ---------------
    with Recorder(mesh3d) as rec_full:
        state = step(state)
    torch.cuda.synchronize()
    results = []
    for kid in ("B1", "B2"):
        a, kw = rec_full.calls[kid][-1]
        err = compare(kid, a, kw)
        k_ms = cuda_ms(lambda: kernel_fn(kid)(*a, **kw), 20)
        p_ms = cuda_ms(lambda: plain_fn(kid)(*a, **kw), 3)
        log(f"{kid} {KERNELS[kid][0]} at full size: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bit-equal")
        name, source, replaces = KERNELS[kid]
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kid],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})
    torch.cuda.synchronize()

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
