"""glTF 2.0 loading (port of bevy_tpu/gltf.py; ref: bevy_gltf — loader →
Mesh/Material/Skin/Animation assets with labeled sub-assets
`src/loader/`): .glb binary container, triangle meshes with
POSITION/NORMAL/(TEXCOORD_0), u16/u32 indices, pbrMetallicRoughness
factors + textures, node TRS transforms, skins (JOINTS_0/WEIGHTS_0 →
dense weight matrix, inverseBindMatrices, joint hierarchy →
animation.Skeleton), and animations (keyframed node TRS channels baked to
uniform-rate AnimationClips — ref: bevy_gltf/src/loader's gltf_curves
adapters).

Host numpy throughout. Images are decoded without an imaging package:
PNG by `decode_png` (zlib); an image in any other format (JPEG, ...)
loads as None, as the JAX loader stores where it cannot decode one.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import List

import numpy as np

from bevy_tpu_torch.render.mesh import Mesh

_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
              5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfPrimitive:
    def __init__(self, mesh: Mesh, base_color, metallic, roughness,
                 base_color_image=None, joints=None, weights=None,
                 material=None, normal_image=None):
        self.mesh = mesh
        self.base_color = base_color
        self.metallic = metallic
        self.roughness = roughness
        self.base_color_image = base_color_image  # (H, W, 4) u8 or None
        self.joints = joints                      # (VC, 4) int or None
        self.weights = weights                    # (VC, 4) f32 or None
        # KHR material-extension fields mapped onto MeshMaterial keys
        # (ref: bevy_gltf/src/material.rs KHR_materials_* handling)
        self.material = material or {}
        self.normal_image = normal_image          # (H, W, 4) u8 or None
        # channel textures (set post-construction by the parser):
        # emissive / metallic-roughness / occlusion images or None
        self.emissive_image = None
        self.mr_image = None
        self.occlusion_image = None

    def dense_weights(self, num_joints: int) -> np.ndarray:
        """(VC, J) dense weight matrix for the MXU skinning einsum
        (ref: the 4-influence loop of skinning.wesl, densified)."""
        vc = self.mesh.num_vertices
        w = np.zeros((vc, num_joints), np.float32)
        if self.joints is not None:
            rows = np.repeat(np.arange(vc), 4)
            cols = np.asarray(self.joints, np.int64).reshape(-1)
            vals = np.asarray(self.weights, np.float32).reshape(-1)
            np.add.at(w, (rows, np.clip(cols, 0, num_joints - 1)), vals)
            s = w.sum(1, keepdims=True)
            w = np.where(s > 1e-8, w / np.maximum(s, 1e-8), w)
        return w


class GltfSkin:
    """A parsed skin: `skeleton` is an animation.Skeleton whose joints are
    re-ordered topologically; `joint_remap[gltf_joint_index]` gives the
    skeleton-local index (apply it to JOINTS_0 before densifying)."""

    def __init__(self, skeleton, joint_remap, node_to_joint):
        self.skeleton = skeleton
        self.joint_remap = joint_remap
        self.node_to_joint = node_to_joint        # node idx → skel joint


class GltfNode:
    def __init__(self, name, translation, rotation, scale, primitives):
        self.name = name
        self.translation = translation
        self.rotation = rotation     # xyzw
        self.scale = scale
        self.primitives: List[GltfPrimitive] = primitives


class GltfDocument:
    def __init__(self, nodes: List[GltfNode], primitives: List[GltfPrimitive],
                 skins=None, animations=None, images=None):
        self.nodes = nodes
        self.primitives = primitives
        self.skins: List[GltfSkin] = skins or []
        self.animations = animations or []    # [(name, {skin → AnimationClip})]
        self.images = images or []            # decoded (H, W, 4) u8 arrays

    def skinned_bundle(self, skin_index=0, animation_names=None):
        """Everything SkinnedMeshPlugin needs for skin `skin_index`:
        (skeleton, mesh, dense_weights, clips). Clips are this document's
        animations baked against that skin's joints (ref: the
        gltf loader's labeled Skin/Animation sub-assets)."""
        skin = self.skins[skin_index]
        prim = next(p for p in self.primitives if p.joints is not None)
        j = skin.skeleton.num_joints
        joints = skin.joint_remap[np.asarray(prim.joints, np.int64)]
        remapped = GltfPrimitive(prim.mesh, prim.base_color, prim.metallic,
                                 prim.roughness, prim.base_color_image,
                                 joints, prim.weights)
        clips = []
        for name, per_skin in self.animations:
            if animation_names is None or name in animation_names:
                clips.append(per_skin[skin_index])
        return skin.skeleton, prim.mesh, remapped.dense_weights(j), clips

    def spawn(self, world, mesh_plugin, root_translation=(0.0, 0.0, 0.0),
              atlas=None, convert_coordinates=False):
        """Instantiate all mesh nodes as Mesh3d entities (ref: glTF scene
        spawning with labeled sub-assets). Pass the Mesh3dPlugin's
        AtlasBuilder as `atlas` to pack each primitive's base-color
        texture and bind its uv rect on the material.
        `convert_coordinates` applies the glTF(+Z forward)→engine(-Z
        forward) 180° yaw (ref: bevy_gltf convert_coordinates.rs)."""
        import torch

        from bevy_tpu_torch.math.quat import quat_mul
        from bevy_tpu_torch.render.mesh3d import Mesh3d, MeshMaterial
        from bevy_tpu_torch.transform import GlobalTransform, Transform

        def _qm(a, b):
            return quat_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()

        rows = []
        packed = {}
        root = np.asarray(root_translation, np.float32)
        yaw = np.asarray([0.0, 1.0, 0.0, 0.0], np.float32)  # 180° about Y
        for node in self.nodes:
            for prim in node.primitives:
                mid = mesh_plugin.add_mesh(prim.mesh)

                def rect_of(image):
                    if atlas is None or image is None:
                        return (0.0, 0.0), (0.0, 0.0)
                    key = id(image)
                    if key not in packed:
                        packed[key] = atlas.add(image)
                    h = packed[key]
                    return h["uv_min"], h["uv_max"]

                uv_min, uv_max = rect_of(prim.base_color_image)
                nm_min, nm_max = rect_of(prim.normal_image)
                em_min, em_max = rect_of(prim.emissive_image)
                mr_min, mr_max = rect_of(prim.mr_image)
                oc_min, oc_max = rect_of(prim.occlusion_image)
                nt = np.asarray(node.translation, np.float32)
                nr = np.asarray(node.rotation, np.float32)
                if convert_coordinates:
                    nt = np.asarray([-nt[0], nt[1], -nt[2]], np.float32)
                    nr = np.asarray(_qm(yaw, nr), np.float32)
                t = tuple(nt + root)
                rows.append(world.spawn(
                    Mesh3d(mesh=mid),
                    MeshMaterial(base_color=tuple(prim.base_color),
                                 metallic=prim.metallic,
                                 perceptual_roughness=prim.roughness,
                                 uv_min=uv_min, uv_max=uv_max,
                                 nm_min=nm_min, nm_max=nm_max,
                                 em_min=em_min, em_max=em_max,
                                 mr_min=mr_min, mr_max=mr_max,
                                 oc_min=oc_min, oc_max=oc_max,
                                 **prim.material),
                    Transform(translation=t, rotation=tuple(nr),
                              scale=tuple(node.scale)),
                    GlobalTransform(translation=t,
                                    rotation=tuple(nr),
                                    scale=tuple(node.scale))))
        return rows


def _read_accessor(gltf, buffers, idx) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    dtype = _COMPONENT[acc["componentType"]]
    n = acc["count"] * _NCOMP[acc["type"]]
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * _NCOMP[acc["type"]]
    if stride and stride != itemsize:
        rows = []
        for i in range(acc["count"]):
            start = offset + i * stride
            rows.append(np.frombuffer(buf, dtype, _NCOMP[acc["type"]], start))
        data = np.concatenate(rows)
    else:
        data = np.frombuffer(buf, dtype, n, offset)
    return data.reshape(acc["count"], _NCOMP[acc["type"]]) \
        if _NCOMP[acc["type"]] > 1 else data


def load_glb(path) -> GltfDocument:
    """Parse a .glb binary container (ref: loader/mod.rs)."""
    raw = Path(path).read_bytes()
    magic, version, _length = struct.unpack_from("<III", raw, 0)
    if magic != 0x46546C67:
        raise ValueError("not a glb file")
    if version != 2:
        raise ValueError(f"unsupported glTF version {version}")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        chunk = raw[offset + 8: offset + 8 + clen]
        if ctype == 0x4E4F534A:      # 'JSON'
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:    # 'BIN'
            bin_chunk = chunk
        offset += 8 + clen
    if gltf is None:
        raise ValueError("glb missing JSON chunk")
    buffers = [bin_chunk]
    return _parse(gltf, buffers)


def load_gltf(path) -> GltfDocument:
    """Parse the .gltf JSON text form (ref: bevy_gltf loader — the same
    document model as .glb, with buffers external via `uri` files or
    embedded as base64 data: URIs)."""
    import base64

    p = Path(path)
    gltf = json.loads(p.read_text())
    gltf["_base_dir"] = str(p.parent)     # for external image URIs
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(b"")            # GLB-style bin has no uri
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote
            buffers.append((p.parent / unquote(uri)).read_bytes())
    return _parse(gltf, buffers)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data) -> np.ndarray:
    """Decode a non-interlaced PNG to (H, W, 4) u8 RGBA (as PIL's
    convert("RGBA") gives it: grey replicated, opaque where there is no
    alpha, a palette through PLTE / tRNS, 16-bit samples by their high
    byte), with zlib alone. Raises ValueError on anything else."""
    data = bytes(data)
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or interlace != 0 or \
            depth not in (1, 2, 4, 8, 16) or \
            (depth < 8 and ctype not in (0, 3)) or (depth == 16 and
                                                     ctype == 3):
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)             # filter unit, bytes
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:          # Sub: a running sum along each byte lane
            cur = np.zeros(stride + (-stride) % bpp, np.int32)
            cur[:stride] = line
            cur = (np.cumsum(cur.reshape(-1, bpp), 0) & 0xFF) \
                .reshape(-1)[:stride]
        elif f == 2:          # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):     # Average, Paeth: left to right
            cur = np.zeros(stride, np.int32)
            for x0 in range(0, stride, bpp):
                sl = slice(x0, min(x0 + bpp, stride))
                b = prev[sl]
                a = cur[x0 - bpp:x0 - bpp + (sl.stop - x0)] if x0 else 0 * b
                if f == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x0 - bpp:x0 - bpp + (sl.stop - x0)] if x0 \
                        else 0 * b
                    p0 = a + b - c
                    pa, pb, pc = np.abs(p0 - a), np.abs(p0 - b), \
                        np.abs(p0 - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[sl] = (line[sl] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
        out[y] = cur
        prev = cur
    if depth == 16:
        px = out.reshape(h, w, ch, 2)[..., 0]
    elif depth == 8:
        px = out.reshape(h, w, ch)
    else:                     # 1, 2 or 4 bits, one channel
        bits = np.unpackbits(out, axis=1).reshape(h, -1, depth)
        vals = np.zeros(bits.shape[:2], np.int32)
        for k in range(depth):
            vals = vals * 2 + bits[..., k]
        px = vals[:, :w, None].astype(np.uint8)
        if ctype == 0:        # scale grey to 8 bits
            px = (px.astype(np.int32) * (255 // (2 ** depth - 1))) \
                .astype(np.uint8)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[..., 0].astype(np.int64)
        rgba[..., :3] = plte[np.clip(idx, 0, len(plte) - 1)]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:min(len(trns), len(plte))] = trns[:len(plte)]
            rgba[..., 3] = alpha[np.clip(idx, 0, len(plte) - 1)]
    elif ch <= 2:
        rgba[..., :3] = px[..., 0:1]
        if ch == 2:
            rgba[..., 3] = px[..., 1]
    else:
        rgba[..., :ch] = px
    return rgba


def _decode_images(gltf, buffers):
    """Decode the document's images to (H, W, 4) u8 (PNG by decode_png;
    None for an image that is not a PNG or does not decode)."""
    out = []
    base_dir = gltf.get("_base_dir")
    for img in gltf.get("images", []):
        data = None
        if "bufferView" in img:
            view = gltf["bufferViews"][img["bufferView"]]
            buf = buffers[view.get("buffer", 0)]
            off = view.get("byteOffset", 0)
            data = buf[off: off + view["byteLength"]]
        elif "uri" in img:               # .gltf text form: file or data URI
            uri = img["uri"]
            try:
                if uri.startswith("data:"):
                    import base64
                    data = base64.b64decode(uri.split(",", 1)[1])
                elif base_dir is not None:
                    from urllib.parse import unquote
                    data = (Path(base_dir) / unquote(uri)).read_bytes()
            except Exception:
                data = None
        if data is None:
            out.append(None)
            continue
        try:
            out.append(decode_png(data))
        except (ValueError, zlib.error):
            out.append(None)
    return out


def _parse_skins(gltf, buffers, parents_all, node_trs):
    """skins[] → GltfSkin with a topologically ordered Skeleton.

    glTF joints reference scene nodes in arbitrary order; the Skeleton
    wants parents-first. We sort joints by node-tree depth, remap the
    parent of each joint to its nearest ancestor that is also a joint
    (glTF guarantees the skeleton subtree is closed under its root)."""
    from bevy_tpu_torch.animation import Skeleton

    skins = []
    for skin in gltf.get("skins", []):
        joints = skin["joints"]
        jset = set(joints)

        def depth(n):
            d = 0
            while parents_all[n] >= 0:
                n = parents_all[n]
                d += 1
            return d

        order = sorted(range(len(joints)), key=lambda k: depth(joints[k]))
        node_to_joint = {}
        remap = np.zeros(len(joints), np.int64)
        for new_idx, old_idx in enumerate(order):
            node_to_joint[joints[old_idx]] = new_idx
            remap[old_idx] = new_idx
        parents = []
        rest_t, rest_r, rest_s = [], [], []
        for old_idx in order:
            node = joints[old_idx]
            p = parents_all[node]
            while p >= 0 and p not in jset:
                p = parents_all[p]
            parents.append(node_to_joint[p] if p >= 0 else -1)
            t, r, s = node_trs[node]
            rest_t.append(t)
            rest_r.append(r)
            rest_s.append(s)
        inv_bind = None
        if "inverseBindMatrices" in skin:
            ibm = _read_accessor(gltf, buffers, skin["inverseBindMatrices"])
            # glTF matrices are column-major flat 16 → (J, 4, 4) transposed
            ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)
            inv_bind = ibm[order]
        skins.append(GltfSkin(
            Skeleton(parents, rest_t, rest_r, rest_s,
                     names=[gltf["nodes"][joints[i]].get("name", f"j{i}")
                            for i in order],
                     inverse_bind=inv_bind),
            remap, node_to_joint))
    return skins


def _parse_animations(gltf, buffers, skins, node_trs):
    """animations[] → [(name, {skin_index: AnimationClip})]. Channels
    keyframe node TRS; each skin bakes the channels that target its
    joints into a uniform-rate clip (ref: AnimationClip curve bake)."""
    from bevy_tpu_torch.animation import AnimationClip

    out = []
    for ai, anim in enumerate(gltf.get("animations", [])):
        samplers = []
        duration = 0.0
        for s in anim.get("samplers", []):
            times = np.asarray(_read_accessor(gltf, buffers, s["input"]),
                               np.float32).reshape(-1)
            vals = np.asarray(_read_accessor(gltf, buffers, s["output"]),
                              np.float32)
            if s.get("interpolation", "LINEAR") == "CUBICSPLINE":
                vals = vals.reshape(len(times), 3, -1)[:, 1]  # keep values
            samplers.append((times, vals.reshape(len(times), -1)))
            if len(times):
                duration = max(duration, float(times[-1]))
        by_node = {}
        for ch in anim.get("channels", []):
            tgt = ch["target"]
            if "node" not in tgt:
                continue
            by_node.setdefault(tgt["node"], {})[tgt["path"]] = \
                samplers[ch["sampler"]]
        per_skin = {}
        for si, skin in enumerate(skins):
            sk = skin.skeleton
            j = sk.num_joints
            inv = {v: k for k, v in skin.node_to_joint.items()}

            def pose_fn(t, _by_node=by_node, _sk=sk, _inv=inv, _j=j):
                tr = _sk.rest_t.copy()
                ro = _sk.rest_r.copy()
                sc = _sk.rest_s.copy()
                for jj in range(_j):
                    chans = _by_node.get(_inv[jj])
                    if not chans:
                        continue
                    for path, (times, vals) in chans.items():
                        row = np.stack([
                            np.interp(t, times, vals[:, k])
                            for k in range(vals.shape[1])])
                        if path == "translation":
                            tr[jj] = row[:3]
                        elif path == "rotation":
                            q = row[:4]
                            n = np.linalg.norm(q)
                            ro[jj] = q / n if n > 1e-8 else [0, 0, 0, 1]
                        elif path == "scale":
                            sc[jj] = row[:3]
                return {"translation": tr, "rotation": ro, "scale": sc}

            per_skin[si] = AnimationClip(max(duration, 1e-3), pose_fn,
                                         rate=30.0)
        out.append((anim.get("name", f"anim{ai}"), per_skin))
    return out


def _parse(gltf, buffers) -> GltfDocument:
    materials = gltf.get("materials", [])
    images = _decode_images(gltf, buffers)
    textures = gltf.get("textures", [])

    def _tex_image(slot):
        if slot is None or not textures:
            return None
        src = textures[slot["index"]].get("source")
        return None if src is None else images[src]

    def material_of(prim):
        """Returns (base_color, metallic, roughness, base_img,
        extras_dict, normal_img). extras_dict keys are MeshMaterial
        field names filled from core emissive + the KHR material
        extensions (ref: bevy_gltf/src/material.rs — transmission,
        volume, clearcoat, ior, anisotropy, emissive_strength, unlit)."""
        mi = prim.get("material")
        if mi is None:
            return ((1.0, 1.0, 1.0, 1.0), 0.0, 0.5, None, {}, None,
                    {"emissive_image": None, "mr_image": None,
                     "occlusion_image": None})
        mat = materials[mi]
        pbr = mat.get("pbrMetallicRoughness", {})
        img = _tex_image(pbr.get("baseColorTexture"))
        nimg = _tex_image(mat.get("normalTexture"))
        extras_imgs = {
            "emissive_image": _tex_image(mat.get("emissiveTexture")),
            "mr_image": _tex_image(pbr.get("metallicRoughnessTexture")),
            "occlusion_image": _tex_image(mat.get("occlusionTexture")),
        }
        ext = mat.get("extensions", {})
        extras = {}
        emissive = np.asarray(mat.get("emissiveFactor", [0, 0, 0]),
                              np.float32)
        es = ext.get("KHR_materials_emissive_strength")
        if es is not None:
            emissive = emissive * float(es.get("emissiveStrength", 1.0))
        if emissive.any():
            extras["emissive"] = tuple(float(v) for v in emissive)
        tr = ext.get("KHR_materials_transmission")
        if tr is not None:
            extras["specular_transmission"] = \
                float(tr.get("transmissionFactor", 0.0))
        vol = ext.get("KHR_materials_volume")
        if vol is not None:
            extras["thickness"] = float(vol.get("thicknessFactor", 0.0))
            ad = float(vol.get("attenuationDistance", 0.0))
            if np.isfinite(ad) and ad > 0.0:
                extras["attenuation_distance"] = ad
            extras["attenuation_color"] = tuple(
                float(v) for v in vol.get("attenuationColor", [1, 1, 1]))
        cc = ext.get("KHR_materials_clearcoat")
        if cc is not None:
            extras["clearcoat"] = float(cc.get("clearcoatFactor", 0.0))
            extras["clearcoat_roughness"] = \
                float(cc.get("clearcoatRoughnessFactor", 0.0))
        io = ext.get("KHR_materials_ior")
        if io is not None:
            extras["ior"] = float(io.get("ior", 1.5))
        an = ext.get("KHR_materials_anisotropy")
        if an is not None:
            extras["anisotropy_strength"] = \
                float(an.get("anisotropyStrength", 0.0))
            extras["anisotropy_rotation"] = \
                float(an.get("anisotropyRotation", 0.0))
        base = tuple(pbr.get("baseColorFactor", [1, 1, 1, 1]))
        metallic = float(pbr.get("metallicFactor", 1.0))
        rough = float(pbr.get("roughnessFactor", 1.0))
        if "KHR_materials_unlit" in ext:
            # unlit: emit base color directly, kill the specular response
            extras["emissive"] = tuple(float(v) for v in base[:3])
            base = (0.0, 0.0, 0.0, base[3])
            metallic, rough = 0.0, 1.0
        return base, metallic, rough, img, extras, nimg, extras_imgs

    mesh_prims: List[List[GltfPrimitive]] = []
    all_prims: List[GltfPrimitive] = []
    for mesh in gltf.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:   # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.tile([0.0, 1.0, 0.0], (len(pos), 1)).astype(np.float32)
            uv = (_read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs
                  else np.zeros((len(pos), 2), np.float32))
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"])
                tris = np.asarray(idx, np.int32).reshape(-1, 3)
            else:
                tris = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            color, metallic, rough, img, extras, nimg, cimgs = \
                material_of(prim)
            joints = weights = None
            if "JOINTS_0" in attrs:
                joints = np.asarray(
                    _read_accessor(gltf, buffers, attrs["JOINTS_0"]),
                    np.int64).reshape(-1, 4)
                weights = np.asarray(
                    _read_accessor(gltf, buffers, attrs["WEIGHTS_0"]),
                    np.float32).reshape(-1, 4)
            p = GltfPrimitive(Mesh(pos, nrm, uv, tris), color, metallic,
                              rough, img, joints, weights,
                              material=extras, normal_image=nimg)
            p.emissive_image = cimgs["emissive_image"]
            p.mr_image = cimgs["mr_image"]
            p.occlusion_image = cimgs["occlusion_image"]
            prims.append(p)
            all_prims.append(p)
        mesh_prims.append(prims)

    # node hierarchy tables (parents + local TRS) for skins/animations
    raw_nodes = gltf.get("nodes", [])
    parents_all = np.full(len(raw_nodes), -1, np.int64)
    for ni, node in enumerate(raw_nodes):
        for c in node.get("children", []):
            parents_all[c] = ni
    node_trs = []
    for node in raw_nodes:
        if "matrix" in node:
            m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
            t = m[:3, 3]
            sx = np.linalg.norm(m[:3, 0])
            sy = np.linalg.norm(m[:3, 1])
            sz = np.linalg.norm(m[:3, 2])
            s = np.asarray([sx, sy, sz], np.float32)
            r3 = m[:3, :3] / np.maximum(s, 1e-8)
            # rotation matrix → quaternion (w-last)
            tr = np.trace(r3)
            if tr > 0:
                qw = np.sqrt(1 + tr) / 2
                q = np.asarray([(r3[2, 1] - r3[1, 2]) / (4 * qw),
                                (r3[0, 2] - r3[2, 0]) / (4 * qw),
                                (r3[1, 0] - r3[0, 1]) / (4 * qw), qw])
            else:
                q = np.asarray([0.0, 0.0, 0.0, 1.0])
            node_trs.append((t.astype(np.float32), q.astype(np.float32), s))
        else:
            node_trs.append((
                np.asarray(node.get("translation", [0, 0, 0]), np.float32),
                np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32),
                np.asarray(node.get("scale", [1, 1, 1]), np.float32)))

    skins = _parse_skins(gltf, buffers, parents_all, node_trs)
    animations = _parse_animations(gltf, buffers, skins, node_trs)

    nodes = []
    for node in raw_nodes:
        if "mesh" not in node:
            continue
        nodes.append(GltfNode(
            node.get("name", ""),
            np.asarray(node.get("translation", [0, 0, 0]), np.float32),
            np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32),
            np.asarray(node.get("scale", [1, 1, 1]), np.float32),
            mesh_prims[node["mesh"]]))
    return GltfDocument(nodes, all_prims, skins, animations, images)


def register_gltf_loader(server):
    """Hook into the asset server (ref: GltfPlugin registering loaders)."""
    server.register_loader(".glb", load_glb)
    server.register_loader(".gltf", load_gltf)
