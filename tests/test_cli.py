"""CLI + presentation-layer tests (render/orbit/fly/info; PNG writer;
physics stepper + fly camera — the reference's game/GL layers recast as
offline commands)."""

import json
import os
import struct
import zlib

import numpy as np
import pytest

from clpathtracer_tpu.cli.main import main
from clpathtracer_tpu.core.physics import (
    FlyCamera, MOVE_SPEED, SPRINT_MODIFIER, WALK_MODIFIER, phys_step)
from clpathtracer_tpu.utils.png import encode_png, tonemap, write_png

CUBE_OBJ = """\
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f 1 2 3 4
f 8 7 6 5
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""


@pytest.fixture
def cube_obj(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    return str(p)


def _decode_png_size(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


class TestPng:
    def test_roundtrip_size_and_crc(self, tmp_path):
        img = np.random.default_rng(0).random((12, 20, 3)).astype(np.float32)
        p = str(tmp_path / "x.png")
        write_png(p, img)
        w, h = _decode_png_size(p)
        assert (w, h) == (20, 12)
        # IDAT decompresses to H*(1+W*3) bytes
        data = open(p, "rb").read()
        off = 8
        raw = b""
        while off < len(data):
            ln = struct.unpack(">I", data[off:off + 4])[0]
            tag = data[off + 4:off + 8]
            if tag == b"IDAT":
                raw += data[off + 8:off + 8 + ln]
            off += 12 + ln
        out = zlib.decompress(raw)
        assert len(out) == 12 * (1 + 20 * 3)

    def test_tonemap_ranges(self):
        hdr = np.array([[[0.0, 1.0, 10.0]]])
        ldr = tonemap(hdr)
        assert ldr.min() >= 0 and ldr.max() <= 1
        assert ldr[0, 0, 2] > ldr[0, 0, 1] > ldr[0, 0, 0]


class TestPhysics:
    def test_phys_step_euler(self):
        # reference PhysStep: pos += vel*dt (src/physics.c:49-64)
        p = phys_step(np.array([1.0, 2.0, 3.0]), np.array([1.0, 0.0, -2.0]),
                      0.5)
        np.testing.assert_allclose(np.asarray(p), [1.5, 2.0, 2.0])

    def test_fly_camera_speed_modifiers(self):
        fc = FlyCamera(position=np.zeros(3))
        fc.move = np.array([0.0, 0.0, 1.0])
        v = fc.velocity()
        np.testing.assert_allclose(np.linalg.norm(v), MOVE_SPEED, rtol=1e-6)
        fc.sprint = True
        np.testing.assert_allclose(np.linalg.norm(fc.velocity()),
                                   MOVE_SPEED * SPRINT_MODIFIER, rtol=1e-6)
        fc.sprint, fc.walk = False, True
        np.testing.assert_allclose(np.linalg.norm(fc.velocity()),
                                   MOVE_SPEED * WALK_MODIFIER, rtol=1e-6)

    def test_pitch_clamped(self):
        # reference clamps pitch at +/- pi/2 (src/game.c:194)
        fc = FlyCamera(position=np.zeros(3))
        fc.look(0.0, -100.0)
        assert fc.pitch < np.pi / 2
        f = fc.forward
        np.testing.assert_allclose(np.linalg.norm(f), 1.0, rtol=1e-6)

    def test_zoom_rescales_fov(self):
        fc = FlyCamera(position=np.zeros(3))
        f0 = fc.fov
        fc.zoom(1.0)
        assert fc.fov < f0


class TestCli:
    def test_render(self, cube_obj, tmp_path):
        out = str(tmp_path / "r.png")
        main(["render", cube_obj, "--width", "32", "--height", "32",
              "--position", "0.5", "0.5", "-1.5", "--forward", "0", "0", "1",
              "--out", out])
        assert _decode_png_size(out) == (32, 32)

    def test_orbit(self, cube_obj, tmp_path):
        d = str(tmp_path / "frames")
        main(["orbit", cube_obj, "--width", "16", "--height", "16",
              "--frames", "3", "--out-dir", d])
        assert sorted(os.listdir(d)) == [
            "frame_0000.png", "frame_0001.png", "frame_0002.png"]

    def test_fly(self, cube_obj, tmp_path):
        script = tmp_path / "script.json"
        script.write_text(json.dumps([
            {"duration": 0.25, "move": [0, 0, 1], "walk": True},
            {"duration": 0.25, "look": [1.0, 0.0]},
        ]))
        d = str(tmp_path / "fly")
        main(["fly", cube_obj, "--script", str(script), "--fps", "8",
              "--width", "16", "--height", "16", "--out-dir", d,
              "--position", "0.5", "0.5", "-2.0"])
        assert len(os.listdir(d)) == 4  # 2 segments x 0.25s x 8fps

    def test_info_json(self, cube_obj, capsys):
        main(["info", cube_obj, "--json"])
        stats = json.loads(capsys.readouterr().out)
        assert stats["num_tris"] == 12
        assert stats["tree_leaves"] > 0

    def test_sharded_render(self, cube_obj, tmp_path):
        out = str(tmp_path / "s.png")
        main(["render", cube_obj, "--width", "16", "--height", "16",
              "--sharded", "--position", "0.5", "0.5", "-1.5",
              "--out", out])
        assert _decode_png_size(out) == (16, 16)


class TestViewer:
    def test_viewer_headless(self, cube_obj, monkeypatch):
        """Viewer constructs, renders a frame, and handles key events under
        the Agg backend (no display)."""
        import matplotlib
        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt
        monkeypatch.setattr(plt, "show", lambda *a, **k: None)
        from clpathtracer_tpu.cli.viewer import run_viewer
        from clpathtracer_tpu.scene.cache import load_model
        from clpathtracer_tpu.render.integrator import RenderOptions
        scene, tree = load_model(cube_obj)
        fc = run_viewer(scene, tree,
                        RenderOptions(width=16, height=16, mode="normal"),
                        position=(0.5, 0.5, -2.0))
        p0 = fc.position.copy()
        fc.move = np.array([0.0, 0.0, 1.0])
        fc.step(0.1)
        assert fc.position[2] > p0[2]

    def test_viewer_mouse_look(self, cube_obj, monkeypatch):
        """Dragging with the left button held turns the camera — the
        reference's raw-mouse look (src/GLState.c:130-133) recast as
        motion_notify deltas."""
        import matplotlib
        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt
        from matplotlib.backend_bases import MouseEvent
        monkeypatch.setattr(plt, "show", lambda *a, **k: None)
        from clpathtracer_tpu.cli.viewer import run_viewer
        from clpathtracer_tpu.render.integrator import RenderOptions
        from clpathtracer_tpu.scene.cache import load_model
        scene, tree = load_model(cube_obj)
        fc = run_viewer(scene, tree,
                        RenderOptions(width=16, height=16, mode="normal"),
                        position=(0.5, 0.5, -2.0))
        fig = plt.gcf()
        yaw0, pitch0 = fc.yaw, fc.pitch
        ax = fig.axes[0]
        (x0, y0), (x1, y1) = ax.bbox.get_points()
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        MouseEvent("button_press_event", fig.canvas, cx, cy,
                   button=1)._process()
        MouseEvent("motion_notify_event", fig.canvas, cx + 40,
                   cy + 25)._process()
        MouseEvent("button_release_event", fig.canvas, cx + 40, cy + 25,
                   button=1)._process()
        assert fc.yaw != yaw0 and fc.pitch != pitch0
        # drag up must pitch UP (non-inverted look): dy>0 -> pitch toward
        # +up, i.e. the pitch moved opposite the pitch-down key direction
        assert (fc.pitch - pitch0) * (+1.0) != 0.0
        # releasing ends the drag: further motion must not turn
        yaw1 = fc.yaw
        MouseEvent("motion_notify_event", fig.canvas, cx + 80,
                   cy)._process()
        assert fc.yaw == yaw1
        plt.close(fig)

    def test_render_with_sphere(self, cube_obj, tmp_path):
        """Sphere primitives via CLI — the reference's dead sphere pipeline
        made real end-to-end."""
        out = str(tmp_path / "sp.png")
        base = str(tmp_path / "base.png")
        main(["render", cube_obj, "--width", "24", "--height", "24",
              "--position", "0.5", "0.5", "-2.0", "--out", base])
        main(["render", cube_obj, "--width", "24", "--height", "24",
              "--position", "0.5", "0.5", "-2.0",
              "--sphere", "0.5", "0.5", "-0.8", "0.3", "--out", out])
        a = open(base, "rb").read()
        b = open(out, "rb").read()
        assert a != b  # the sphere occludes part of the cube


def _decode_png_rgb(path):
    raw = open(path, "rb").read()
    pos, w, h, data = 8, None, None, b""
    while pos < len(raw):
        ln = struct.unpack(">I", raw[pos:pos + 4])[0]
        typ = raw[pos + 4:pos + 8]
        if typ == b"IHDR":
            w, h = struct.unpack(">II", raw[pos + 8:pos + 16])
        elif typ == b"IDAT":
            data += raw[pos + 8:pos + 8 + ln]
        pos += 12 + ln
    rows = zlib.decompress(data)
    stride = w * 3 + 1
    img = np.frombuffer(rows, np.uint8).reshape(h, stride)
    assert (img[:, 0] == 0).all(), "test expects filter-0 scanlines"
    return img[:, 1:].reshape(h, w, 3)
