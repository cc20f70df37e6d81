"""bevy_tpu_torch's custom materials (`Mesh3dPlugin(material_fn=...)`,
`extended_material`) and the material depth bias against the JAX
package: the worlds of tests/test_custom_material.py,
test_extended_material.py and test_depth_bias_uvt.py, whole, against
the JAX package's frames stored by tests/make_torch_goldens.py (its
Pallas kernels in interpret mode), under the golden rule (under 1% of
pixels drift by more than 8); then the reference tests' own behaviours
on the port. A material function is user code, so each package's world
takes one written for its arrays (torch_scenes.toon_material,
quantize_extension: the same arithmetic).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402

GOLDENS = ROOT / "tests" / "goldens"
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def m():
    return ts.port_scene_modules()


def _stored(name):
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys[name] == ts.golden_key(name), \
        f"{name}: the scene changed; run tests/make_torch_goldens.py {name}"
    from PIL import Image
    return np.asarray(Image.open(GOLDENS / f"{name}.png")).astype(int)


def golden_rule(img, ref):
    assert img.shape == ref.shape
    d = np.abs(img - ref).max(-1)
    assert (d > 8).mean() < 0.01, ((d > 8).mean(), d.max())


@pytest.mark.parametrize("kind", ["toon", "quantize"])
def test_shader_world_matches_jax(m, kind):
    img, app = ts.shader_world(m, CPU, {}, kind)
    golden_rule(img, _stored(f"shader_{kind}"))
    cov = np.abs(img - img[0, 0]).max(-1) > 10
    assert cov.mean() > 0.1
    # banding: few distinct levels inside the sphere (the reference tests')
    chan = 0 if kind == "toon" else 2
    assert len(np.unique(img[cov][:, chan] // 8)) <= 6


def test_extended_material_identity_is_standard(m):
    """ExtendedMaterial with a pass-through extension reproduces the
    standard forward shade exactly; quantizing changes the shade but not
    the coverage."""
    std, _ = ts.shader_world(m, CPU, {}, "standard")
    ident, _ = ts.shader_world(m, CPU, {}, "identity")
    assert np.array_equal(std, ident)
    quant, _ = ts.shader_world(m, CPU, {}, "quantize")
    assert not np.array_equal(std, quant)
    cov_s = np.abs(std - std[0, 0]).max(-1) > 10
    cov_q = np.abs(quant - quant[0, 0]).max(-1) > 10
    assert abs(cov_s.mean() - cov_q.mean()) < 0.02


@pytest.mark.parametrize("bias", [1.0, -1.0], ids=["green", "red"])
def test_depth_bias_world_matches_jax(m, bias):
    """Two exactly coplanar quads: the biased green one wins at bias 1,
    the red one at -1 (ref: StandardMaterial::depth_bias)."""
    img, _ = ts.bias_world(m, CPU, {}, bias)
    golden_rule(img, _stored("bias_green" if bias > 0 else "bias_red"))
    c = img[48, 64]
    if bias > 0:
        assert c[1] > c[0] + 40, c
    else:
        assert c[0] > c[1] + 40, c
