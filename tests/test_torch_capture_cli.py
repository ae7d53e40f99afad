"""The port's capture CLIs, drive-dump loader and tree generators against JAX's.

On the CPU at test sizes, the same trees and captures through both:
- ``make_drive_dump``, ``make_bdd`` and ``make_vistas_borders``: the same
  file names and texts, and every file decodes to the array the JAX
  generator handed to ``cv2.imwrite`` (PNG bytes may differ: the port has
  its own encoder; its ``.jpg`` files hold PNG bytes);
- ``ThermalDriveDataset``: items equal, with and without
  ``contrast_enhancement``, ``load_aligned_ir`` and ``load_right``;
- ``imread_grayscale`` and ``imread_bgr``: ``cv2.imread``'s decodes on
  every pixel (all 2^24 colours for the grey conversion);
- ``cli.dump_capture``: the same tree, texts and pixels as JAX's on the
  same capture, raw, rectified through a kalibr camchain, and with a lidar
  topic; ``cli.camera_focus``'s FDEs within 1e-12; ``cli.visualize_data``'s
  PNGs pixel for pixel; the JET table and ``addWeighted`` equal cv2 on all
  inputs; ``cli.plot_heatmap``'s harvest; the four CLIs' argparse
  destinations and defaults.
"""

import datetime
import json
import os

import numpy as np
import pytest

from heatnet_tpu_torch.data import loaders as tl
from heatnet_tpu_torch.data import synthetic as ts
from heatnet_tpu_torch.data.png import read_png, write_png

cv2 = pytest.importorskip("cv2")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def _text(path, root):
    return open(path).read().replace(str(root), "<root>")


@pytest.mark.parametrize("gen", ["make_drive_dump", "make_bdd", "make_vistas_borders"])
def test_generators_write_the_jax_trees(gen, tmp_path, monkeypatch):
    """Tolerance: none; names and texts equal, and each port file decodes
    (cv2, ``IMREAD_UNCHANGED``) to the array JAX's generator wrote."""
    from heatnet_tpu.data import synthetic as js

    written = {}
    real = cv2.imwrite
    monkeypatch.setattr(cv2, "imwrite",
                        lambda p, a: written.__setitem__(p, a.copy()) or real(p, a))
    jroot, proot = tmp_path / "j", tmp_path / "p"
    kw = {"hw": (24, 32)} if gen != "make_bdd" else {}
    jret, pret = getattr(js, gen)(str(jroot), **kw), getattr(ts, gen)(str(proot), **kw)
    assert pret.replace(str(proot), "") == jret.replace(str(jroot), "")
    jf, pf = _files(jroot), _files(proot)
    assert jf.keys() == pf.keys() and len(pf) > 4
    for rel, p in pf.items():
        if rel.endswith((".png", ".jpg")):
            got = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            want = written[jf[rel]]
            assert got.dtype == want.dtype and np.array_equal(got, want), rel
        else:
            assert _text(p, proot) == _text(jf[rel], jroot), rel


@pytest.mark.parametrize("opts", [{}, {"contrast_enhancement": True},
                                  {"load_aligned_ir": True, "load_right": False}],
                         ids=["default", "clahe", "aligned_left_only"])
def test_thermal_drive_dataset_equals_jax(opts, tmp_path):
    """Tolerance: none; every item's arrays, dtypes and paths equal JAX's."""
    from heatnet_tpu.data.loaders import ThermalDriveDataset as JaxDataset

    root = ts.make_drive_dump(str(tmp_path), n_drives=2, n_bursts=2, burst=2, hw=(32, 40))
    ours, theirs = tl.ThermalDriveDataset(root, **opts), JaxDataset(root, **opts)
    assert len(ours) == len(theirs) == 4
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], list) and b[k] and isinstance(b[k][0], np.ndarray):
                assert len(a[k]) == len(b[k]) and all(
                    x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
            elif isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_grey_and_colour_decodes_equal_cv2(tmp_path):
    """Tolerance: none; ``imread_grayscale`` = ``IMREAD_GRAYSCALE`` on all
    2^24 colours (RGB) and on RGBA, 8- and 16-bit grey files (and
    ``any_depth`` = ``IMREAD_ANYDEPTH``); ``imread_bgr`` = ``cv2.imread``."""
    px = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(px >> 16) & 255, (px >> 8) & 255, px & 255], -1)
    write_png(str(tmp_path / "all.png"), rgb.astype(np.uint8).reshape(4096, 4096, 3), level=0)
    assert np.array_equal(tl.imread_grayscale(str(tmp_path / "all.png")),
                          cv2.imread(str(tmp_path / "all.png"), cv2.IMREAD_GRAYSCALE))
    rng = np.random.RandomState(9)
    for name, arr in (("rgba", rng.randint(0, 256, (20, 30, 4)).astype(np.uint8)),
                      ("rgb", rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)),
                      ("g8", rng.randint(0, 256, (20, 30)).astype(np.uint8)),
                      ("g16", rng.randint(0, 65536, (20, 30)).astype(np.uint16))):
        p = str(tmp_path / f"{name}.png")
        write_png(p, arr)
        for flag, any_depth in ((cv2.IMREAD_GRAYSCALE, False), (cv2.IMREAD_ANYDEPTH, True)):
            want = cv2.imread(p, flag)
            got = tl.imread_grayscale(p, any_depth=any_depth)
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, flag)
        if arr.dtype == np.uint8:
            assert np.array_equal(tl.imread_bgr(p), cv2.imread(p)), name


def _write_capture(cap, topics, n_frames=12, dt=0.03, hw=(48, 64), seed=0):
    """A recorded capture: frames per topic at ``dt`` with 1 ms skew between
    streams, ``tf.jsonl`` moving fast enough for >10 m heat points, and
    ``origin.json`` (the layout of ``tests/test_capture_tools.py``)."""
    rng = np.random.default_rng(seed)
    base = 1594000000.0
    for ti, topic in enumerate(topics):
        d = os.path.join(cap, "streams", topic)
        os.makedirs(d)
        for i in range(n_frames):
            t = base + i * dt + ti * 0.001
            stem = os.path.join(d, f"{int(t)}_{int(round((t - int(t)) * 1e9))}")
            if "lidar" in topic:
                np.save(stem + ".npy", rng.standard_normal((16, 4), dtype=np.float32))
            elif "ir" in topic:
                write_png(stem + ".png", rng.integers(21000, 26000, hw, dtype=np.uint16))
            else:
                write_png(stem + ".png", rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    with open(os.path.join(cap, "tf.jsonl"), "w") as f:
        for i in range(n_frames + 2):
            f.write(json.dumps({
                "t": base - dt + i * dt, "parent": "odom_combined", "child": "base_link",
                "translation": [20.0 * i * dt, 0.3 * i * dt, 0.0],
                "rotation": [0.0, 0.0, 0.0, 1.0]}) + "\n")
    with open(os.path.join(cap, "origin.json"), "w") as f:
        json.dump({"position": [413135.0, 5318474.0, 0.0]}, f)


_SMALL_CAMCHAIN = """left:
  distortion_model: equidistant
  distortion_coeffs: [0.015, -0.004, 0.001, -0.0005]
  intrinsics: [32.7, 32.7, 32.0, 24.0]
  resolution: [64, 48]
right:
  distortion_model: equidistant
  distortion_coeffs: [0.014, -0.0035, 0.0012, -0.0004]
  intrinsics: [32.7, 32.6, 31.9, 24.1]
  resolution: [64, 48]
  T_cn_cnm1:
  - [0.9998, -0.0175, 0.0, -0.5]
  - [0.0175, 0.9998, 0.0, 0.01]
  - [0.0, 0.0, 1.0, 0.0]
  - [0.0, 0.0, 0.0, 1.0]
"""


@pytest.mark.parametrize("case", ["raw", "calib", "lidar"])
def test_dump_capture_writes_the_jax_tree(case, tmp_path):
    """Tolerance: none; the same files, texts (output roots aside) and
    pixels as JAX's ``cli.dump_capture`` on the same capture; the
    heatmap's page keeps JAX's title and point count (its picture differs
    by design)."""
    from heatnet_tpu.cli import dump_capture as jdump
    from heatnet_tpu_torch.cli import dump_capture as pdump

    topics = ["rgb_fl_burst", "ir_left_burst"]
    prefixes = ["fl_rgb", "fl_ir"]
    extra = []
    if case == "calib":
        topics, prefixes = ["rgb_fl_burst", "rgb_fr_burst", "ir_left_burst"], \
            ["fl_rgb", "fr_rgb", "fl_ir"]
        (tmp_path / "camchain.yaml").write_text(_SMALL_CAMCHAIN)
        extra = ["--calib", str(tmp_path / "camchain.yaml"), "--calib-cams", "left", "right"]
    if case == "lidar":
        topics, prefixes = topics + ["lidar_burst"], prefixes + ["lidar"]
    cap = str(tmp_path / "capture")
    _write_capture(cap, topics)
    outs = {}
    for name, mod in (("jax", jdump), ("port", pdump)):
        out = tmp_path / f"out_{name}"
        argv = ["--capture", cap, "--out", str(out), "--topics", *topics,
                "--prefixes", *prefixes, "--heatmap-min-dist", "0.5", *extra]
        save_dir = mod.main(argv)
        assert save_dir is not None and mod.main(argv) is None  # already parsed
        outs[name] = (out, _files(out))
    (jroot, jf), (proot, pf) = outs["jax"], outs["port"]
    assert jf.keys() == pf.keys()
    assert sum(k.endswith(".png") for k in pf) >= 5 * len([t for t in topics if "lidar" not in t])
    first = datetime.datetime.fromtimestamp(1594000000)
    day = "night" if (first.hour >= 22 or first.hour < 6) else "day"
    assert all(k.startswith(f"drive_{day}_") for k in pf)
    for rel, p in pf.items():
        if rel.endswith(".png"):
            a, b = read_png(p), read_png(jf[rel])
            assert a.dtype == b.dtype and np.array_equal(a, b), rel
            if case == "calib" and "rgb" in rel:
                assert a.shape == (48, 64, 3)
        elif rel.endswith(".npy"):
            assert np.array_equal(np.load(p), np.load(jf[rel]))
        elif rel.endswith("heatmap.html"):
            head = lambda s: s.split("<img")[0]  # noqa: E731
            assert head(open(p).read()) == head(open(jf[rel]).read())
        else:
            assert _text(p, proot) == _text(jf[rel], jroot), rel
    for rel in (k for k in pf if k.split(os.sep)[1] == "paths"):
        for line in open(pf[rel]):
            assert len(line.split()) == 5 and all(os.path.isfile(q) for q in line.split())


def test_camera_focus_equals_jax(tmp_path):
    """Tolerance: 1e-12 relative on each FDE; a JPEG frame raises in the port
    (no JPEG decoder)."""
    from heatnet_tpu.cli import camera_focus as jcf
    from heatnet_tpu_torch.cli import camera_focus as pcf

    rng = np.random.RandomState(10)
    d = tmp_path / "frames"
    d.mkdir()
    write_png(str(d / "a.png"), rng.randint(0, 256, (40, 56, 3)).astype(np.uint8))
    write_png(str(d / "b.png"), rng.randint(0, 256, (40, 56, 4)).astype(np.uint8))
    write_png(str(d / "c.png"), rng.randint(0, 65536, (40, 56)).astype(np.uint16))
    write_png(str(d / "d.png"), np.zeros((8, 8), np.uint8))
    got, want = pcf.main(["--images", str(d)]), jcf.main(["--images", str(d)])
    assert got.keys() == want.keys() and len(got) == 4
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)
    cv2.imwrite(str(tmp_path / "e.jpg"), rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        pcf.main(["--images", str(tmp_path / "e.jpg")])


def test_jet_and_add_weighted_equal_cv2():
    """Tolerance: none; the JET table on all 256 inputs, ``addWeighted`` on
    all 256x256 pairs at the CLI's alpha 0.7 and at 0.3."""
    from heatnet_tpu_torch.cli import visualize_data as vd

    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(vd.apply_jet(ramp), cv2.applyColorMap(ramp, cv2.COLORMAP_JET))
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    for alpha in (0.7, 0.3):
        assert np.array_equal(vd.add_weighted(a, alpha, b, 1.0 - alpha, 0.0),
                              cv2.addWeighted(a, alpha, b, 1.0 - alpha, 0.0))


def test_visualize_data_writes_the_jax_pngs(tmp_path):
    """Tolerance: none; the same triples, pixel for pixel."""
    from heatnet_tpu.cli import visualize_data as jvd
    from heatnet_tpu_torch.cli import visualize_data as pvd

    root = ts.make_drive_dump(str(tmp_path / "dump"), n_drives=1, n_bursts=3, burst=2,
                              hw=(32, 48))
    argv = ["-s", root, "--start", "1", "--ir-min", "22000", "--ir-max", "25500"]
    assert pvd.main(argv + ["--save-dir", str(tmp_path / "p")]) == \
        jvd.main(argv + ["--save-dir", str(tmp_path / "j")]) == 2
    pf, jf = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert pf.keys() == jf.keys() and len(pf) == 6
    for rel in pf:
        a, b = cv2.imread(pf[rel], cv2.IMREAD_UNCHANGED), cv2.imread(jf[rel], cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and np.array_equal(a, b), rel


def test_plot_heatmap_harvests_as_jax(tmp_path):
    """Tolerance: none; the same count and the same page heading."""
    from heatnet_tpu.cli import plot_heatmap as jph
    from heatnet_tpu_torch.cli import plot_heatmap as pph
    from heatnet_tpu_torch.utils.gps_heatmap import save_heat_stats

    rng = np.random.RandomState(11)
    for sub in ("a", "b/c"):
        os.makedirs(tmp_path / "core" / sub)
        save_heat_stats(48 + rng.uniform(0, 1e-2, 7), 7.8 + rng.uniform(0, 1e-2, 7),
                        str(tmp_path / "core" / sub / "heat_stats_x"))
    core = str(tmp_path / "core")
    assert pph.main(["--core-dir", core, "--out", str(tmp_path / "p.html")]) == \
        jph.main(["--core-dir", core, "--out", str(tmp_path / "j.html")]) == 14
    head = lambda p: open(p).read().split("<img")[0]  # noqa: E731
    assert head(tmp_path / "p.html") == head(tmp_path / "j.html")
    assert pph.main(["--core-dir", str(tmp_path / "core" / "a"), "--pattern", "none*"]) == 0


@pytest.mark.parametrize("cli", ["dump_capture", "camera_focus", "plot_heatmap",
                                 "visualize_data"])
def test_cli_flags_equal_jax(cli):
    """The argparse destinations, defaults, option strings and required
    flags equal the JAX CLI's."""
    import importlib

    def surface(mod):
        return sorted((a.dest, repr(a.default), tuple(a.option_strings), a.required,
                       repr(a.nargs), getattr(a.type, "__name__", None))
                      for a in mod.build_parser()._actions)

    ours = importlib.import_module(f"heatnet_tpu_torch.cli.{cli}")
    theirs = importlib.import_module(f"heatnet_tpu.cli.{cli}")
    assert surface(ours) == surface(theirs)
