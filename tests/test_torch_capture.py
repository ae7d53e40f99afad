"""The port's capture data modules against the JAX package's, on the CPU.

Held on the same seeded numpy inputs: ``data/transforms3d.py``,
``data/tf_store.py``, ``data/pointcloud.py`` and ``utils/gps_heatmap.py``
(copies: equal, or within 1e-12 where a test says so); the kalibr reader
against ``yaml.safe_load``; the numpy copies of cv2's fisheye
rectification (``data/calibration.py``) against cv2 5.0 and against the
JAX ``StereoRectifier`` at the shipped rig's 1920x1080; the heatmap picture
against matplotlib's ``hot`` table; and an AST scan: no new port module
imports cv2, PIL, yaml or matplotlib.
"""

import ast
import base64
import os

import numpy as np
import pytest

from heatnet_tpu.data import calibration as jcal
from heatnet_tpu.data import pointcloud as jpc
from heatnet_tpu.data import tf_store as jtf
from heatnet_tpu.data import transforms3d as jt3
from heatnet_tpu.utils import gps_heatmap as jgps
from heatnet_tpu_torch.data import calibration as cal
from heatnet_tpu_torch.data import pointcloud as pc
from heatnet_tpu_torch.data import tf_store as tf
from heatnet_tpu_torch.data import transforms3d as t3
from heatnet_tpu_torch.utils import gps_heatmap as gps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = os.path.join(ROOT, "experiments", "calibrations")
STEREO = os.path.join(CALIB, "example_rig", "front_stereo", "camchain.yaml")

NEW_MODULES = ["native/bindings.py", "native/__init__.py", "data/transforms3d.py",
               "data/tf_store.py", "data/pointcloud.py", "data/calibration.py",
               "data/loaders.py::ThermalDriveDataset,imread_grayscale,imread_bgr",
               "data/synthetic.py", "data/png.py",
               "utils/gps_heatmap.py", "cli/dump_capture.py", "cli/camera_focus.py",
               "cli/plot_heatmap.py", "cli/visualize_data.py", "cli/generate_vistas.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_capture_modules_import_no_cv2_pil_yaml_matplotlib(rel):
    """Whole modules, or the named definitions of ``data/loaders.py`` (whose
    JPEG readers take PIL or cv2 where they import)."""
    rel, _, names = rel.partition("::")
    tree = ast.parse(open(os.path.join(ROOT, "heatnet_tpu_torch", rel)).read())
    nodes = [n for n in tree.body if getattr(n, "name", None) in names.split(",")]
    assert len(nodes) == len(names.split(",")) if names else True
    roots = set()
    for node in (n for top in (nodes if names else [tree]) for n in ast.walk(top)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"cv2", "PIL", "yaml", "matplotlib"}, roots


# ---------------------------------------------------------------------------
# transforms3d, tf_store, pointcloud, UTM: copies
# ---------------------------------------------------------------------------

def test_transforms3d_equal_jax():
    """Tolerance: 1e-12 absolute on every output (the same float64 code)."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        q0, q1 = jt3.random_quaternion(rng), jt3.random_quaternion(rng)
        ang, axis, pt = rng.uniform(-3, 3), rng.standard_normal(3), rng.standard_normal(3)
        m = jt3.concatenate_matrices(jt3.rotation_matrix(ang, axis, pt),
                                     jt3.translation_matrix(pt))
        for name, args in (("quaternion_matrix", (q0,)), ("quaternion_from_matrix", (m,)),
                           ("quaternion_multiply", (q0, q1)), ("quaternion_inverse", (q0,)),
                           ("quaternion_slerp", (q0, q1, 0.3)),
                           ("quaternion_about_axis", (ang, axis)),
                           ("rotation_matrix", (ang, axis, pt)), ("rigid_inverse", (m,)),
                           ("inverse_matrix", (m,)), ("euler_from_matrix", (m, "rzxy")),
                           ("euler_matrix", (0.1, -0.4, ang, "sxyz")),
                           ("quaternion_from_euler", (0.2, ang, -0.3, "ryxz")),
                           ("euler_from_quaternion", (q1,)), ("pair_to_matrix", (pt, q0)),
                           ("matrix_to_pair", (m,)), ("unit_vector", (axis,))):
            got, want = getattr(t3, name)(*args), getattr(jt3, name)(*args)
            np.testing.assert_allclose(np.concatenate([np.ravel(x) for x in got])
                                       if name == "matrix_to_pair" else got,
                                       np.concatenate([np.ravel(x) for x in want])
                                       if name == "matrix_to_pair" else want,
                                       rtol=0, atol=1e-12, err_msg=name)


def _stamped(mod, rng, n=30):
    out = []
    for i in range(n):
        t = 100.0 + i * 0.1 + rng.uniform(0, 0.02)
        q = jt3.random_quaternion(rng)
        out.append(mod.StampedTransform("odom", "base_link", t,
                                        tuple(rng.standard_normal(3)), tuple(q)))
        if i % 3 == 0:
            out.append(mod.StampedTransform("base_link", "camera", t + 0.01,
                                            tuple(rng.standard_normal(3) * 0.1),
                                            tuple(jt3.random_quaternion(rng))))
    out.append(mod.StampedTransform("camera", "ir", 100.0, (0.1, 0.0, 0.0),
                                    (0.0, 0.0, 0.0, 1.0)))
    return out


def test_tf_store_equal_jax(tmp_path):
    """Tolerance: 1e-12 absolute on translations and quaternions; stamps,
    chains, failures and the JSONL round trip equal."""
    a, b = (m.TransformStore(_stamped(m, np.random.default_rng(1))) for m in (tf, jtf))
    assert a.get_frame_strings() == b.get_frame_strings()
    assert a.get_chain("odom", "ir") == b.get_chain("odom", "ir")
    rng = np.random.default_rng(2)
    for t in rng.uniform(99.5, 104, 25):
        for orig, dest in (("odom", "base_link"), ("odom", "ir"), ("camera", "odom")):
            try:
                want = b.lookup_transform(orig, dest, t)
            except jtf.TransformLookupError:
                with pytest.raises(tf.TransformLookupError):
                    a.lookup_transform(orig, dest, t)
                continue
            got = a.lookup_transform(orig, dest, t)
            np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=1e-12)
    pairs = [b.lookup_transform("odom", "base_link", t) for t in (101.0, 101.5, 102.0)]
    np.testing.assert_allclose(np.concatenate(tf.TransformStore.average_transforms(pairs)),
                               np.concatenate(jtf.TransformStore.average_transforms(pairs)),
                               atol=1e-12)
    got = a.average_transform_over_time("odom", "base_link", 100.5, 102.5)
    want = b.average_transform_over_time("odom", "base_link", 100.5, 102.5)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=1e-12)
    a.replicate_transform_over_time(pairs[0], "base_link", "lidar", 10.0, 100.0, 101.0)
    b.replicate_transform_over_time(pairs[0], "base_link", "lidar", 10.0, 100.0, 101.0)
    np.testing.assert_allclose(np.concatenate(a.lookup_transform("odom", "lidar", 100.55)),
                               np.concatenate(b.lookup_transform("odom", "lidar", 100.55)),
                               atol=1e-12)
    a.to_jsonl(str(tmp_path / "a.jsonl"))
    b.to_jsonl(str(tmp_path / "b.jsonl"))
    assert open(tmp_path / "a.jsonl").read() == open(tmp_path / "b.jsonl").read()
    c = tf.TransformStore.from_jsonl(str(tmp_path / "b.jsonl"))
    assert c.get_transform_update_times("odom", "base_link") == \
        b.get_transform_update_times("odom", "base_link")


def test_pointcloud_equal_jax():
    """Tolerance: none; fields, padding and decoded records equal."""
    dt = np.dtype({"names": ["x", "y", "z", "intensity", "ring"],
                   "formats": [np.float32, np.float32, np.float32, np.float32, np.uint16],
                   "offsets": [0, 4, 8, 16, 20], "itemsize": 24})
    arr = np.zeros(50, dt)
    rng = np.random.default_rng(3)
    for k in ("x", "y", "z", "intensity"):
        arr[k] = rng.standard_normal(50)
    arr["ring"] = rng.integers(0, 64, 50)
    got, want = pc.array_to_cloud(arr), jpc.array_to_cloud(arr)
    assert [tuple(vars(f).values()) for f in got.fields] == \
        [tuple(vars(f).values()) for f in want.fields]
    assert got.data == want.data and got.point_step == want.point_step
    assert pc.fields_to_dtype(got.fields, 24) == jpc.fields_to_dtype(want.fields, 24)
    a, b = pc.cloud_to_array(got), jpc.cloud_to_array(want)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert np.array_equal(pc.xyz_from_cloud(got), jpc.xyz_from_cloud(want))


def test_utm_and_heat_stats_equal_jax(tmp_path):
    """Tolerance: none on the UTM conversions (the same float64 series);
    heat stats files and their harvest equal."""
    rng = np.random.default_rng(4)
    for lat, lon in zip(rng.uniform(-79, 83, 40), rng.uniform(-179, 179, 40)):
        assert gps.latlon_to_utm(lat, lon) == jgps.latlon_to_utm(lat, lon)
        e, n, z, letter = jgps.latlon_to_utm(lat, lon)
        assert gps.utm_to_latlon(e, n, z, letter) == jgps.utm_to_latlon(e, n, z, letter)
    lats, lons = list(48 + rng.uniform(0, 0.01, 20)), list(7.8 + rng.uniform(0, 0.01, 20))
    for mod, d in ((gps, "p"), (jgps, "j")):
        os.makedirs(tmp_path / d / "x")
        mod.save_heat_stats(lats[:12], lons[:12], str(tmp_path / d / "heat_stats_a"))
        mod.save_heat_stats(lats[12:], lons[12:], str(tmp_path / d / "x" / "heat_stats_b"))
    assert open(tmp_path / "p" / "heat_stats_a").read() == \
        open(tmp_path / "j" / "heat_stats_a").read()
    assert sorted(zip(*gps.collect_heat_stats(str(tmp_path / "p")))) == \
        sorted(zip(*jgps.collect_heat_stats(str(tmp_path / "j"))))


def test_heatmap_is_the_density_raster_in_matplotlibs_hot(tmp_path):
    """The raster equals JAX's within 1e-12; the colours are matplotlib's
    ``hot`` entries (equal on all 256); the HTML has JAX's title and count."""
    import matplotlib

    from heatnet_tpu_torch.data.png import read_png

    hot = matplotlib.colormaps["hot"](np.arange(256), bytes=True)[:, :3]
    assert np.array_equal(gps._HOT, hot)
    rng = np.random.default_rng(5)
    lats, lons = 48 + np.cumsum(rng.uniform(0, 1e-4, 60)), 7.8 + np.cumsum(rng.uniform(0, 1e-4, 60))
    d, ext = gps._density_raster(lats, lons)
    jd, jext = jgps._density_raster(lats, lons)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-12)
    assert ext == jext
    img = gps.render_heatmap(lats, lons)
    assert img.shape == (256 * gps._UPSCALE,) * 2 + (3,) and img.dtype == np.uint8
    corner = img[0, 0]  # no point lands in the padded corner: density's own colour
    idx = int(min((d[-1, 0] - d.min()) / (d.max() - d.min()) * 256, 255))
    assert np.array_equal(corner, hot[idx])
    out = gps.write_heatmap_html(lats, lons, str(tmp_path / "h" / "map.html"), title="T")
    html = open(out).read()
    assert "<title>T</title>" in html and "T — 60 points" in html
    png = html.split("base64,")[1].split("'")[0]
    (tmp_path / "h.png").write_bytes(base64.b64decode(png))
    assert np.array_equal(read_png(str(tmp_path / "h.png")), img)


# ---------------------------------------------------------------------------
# calibration: the kalibr reader, cv2's fisheye rectification and remap
# ---------------------------------------------------------------------------

_VARIANT = """%YAML 1.1
---
# kalibr camchain written by a calibration run
cam0:
  T_cam_imu:
  - [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975]
  - [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768]
  - [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949]
  - [0.0, 0.0, 0.0, 1.0]
  cam_overlaps: [1]
  camera_model: pinhole
  distortion_coeffs: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
  distortion_model: 'radtan'
  intrinsics: [458.654, 457.296, 367.215, 248.375]  # fx fy cx cy
  resolution: [752, 480]
  rostopic: /cam0/image_raw
  timeshift_cam_imu: -0.0
  flags: {rectified: false, note: "a # inside quotes", n: 0x1F}
  empty:
  listed:
    - 1
    - two
    -
  long_list: [1, 2,
              3, 4]
cam1:
  T_cn_cnm1:
  - [0.999997256478, -0.002312067192, -0.000376008102, -0.110073808127]
  - [0.002317135723, 0.999898048507, 0.014089835846, 0.000399121409]
  - [0.000343393121, -0.014090668452, 0.999900662638, -0.000853702503]
  - [0.0, 0.0, 0.0, 1.0]
  intrinsics: [457.587, 456.134, 379.999, 255.238]
  distortion_coeffs: [1e-3, .5, -1.5e+2, 7]
  resolution: [752, 480]
  yes_no: [yes, No, ~, null, 'it''s', .inf, -.Inf, 010, +12, 1_000]
"""


def test_kalibr_reader_equals_yaml_safe_load(tmp_path):
    """Tolerance: none (NaN aside, no float in these files): every shipped
    YAML file and a kalibr-style variant with comments, quotes, flow and
    block lists, PyYAML's YAML 1.1 scalars and a wrapped flow list."""
    import glob

    import yaml

    files = sorted(glob.glob(os.path.join(CALIB, "**", "*.yaml"), recursive=True))
    (tmp_path / "v.yaml").write_text(_VARIANT)
    files.append(str(tmp_path / "v.yaml"))
    assert len(files) >= 4
    for f in files:
        with open(f) as fh:
            assert cal.load_yaml(f) == yaml.safe_load(fh), f
    want, got = jcal.load_kalibr_yaml(STEREO), cal.load_kalibr_yaml(STEREO)
    assert got.keys() == want.keys()
    for k in got:
        for field in ("K", "D", "resolution", "distortion_model", "T_cn_cnm1"):
            assert np.array_equal(getattr(got[k], field), getattr(want[k], field)), field


def _rig():
    cams = cal.load_kalibr_yaml(STEREO)
    return cams["left"], cams["right"], cams["right"].T_cn_cnm1


def test_remap_on_cv2_maps_equals_cv2_bit_for_bit():
    """Tolerance: none; uint8 3-channel and uint16 frames at 1920x1080 through
    cv2's own rectification maps of the shipped rig, and random maps that
    reach past every border."""
    import cv2

    left, right, T = _rig()
    r1, r2, p1, p2, _ = cv2.fisheye.stereoRectify(
        left.K, left.D, right.K, right.D, left.resolution, T[:3, :3], T[:3, 3],
        cv2.CALIB_ZERO_DISPARITY, fov_scale=1.0, balance=0.0)
    maps = cv2.fisheye.initUndistortRectifyMap(left.K, left.D, r1, p1, left.resolution,
                                               cv2.CV_16SC2)
    rng = np.random.RandomState(6)
    rgb = rng.randint(0, 256, (1080, 1920, 3)).astype(np.uint8)
    ir = rng.randint(0, 65536, (1080, 1920)).astype(np.uint16)
    for img in (rgb, ir):
        assert np.array_equal(cal.remap(img, *maps),
                              cv2.remap(img, *maps, interpolation=cv2.INTER_LINEAR))
    m1 = np.stack([rng.randint(-3, 67, (40, 50)), rng.randint(-3, 51, (40, 50))],
                  -1).astype(np.int16)
    m2 = rng.randint(0, 1024, (40, 50)).astype(np.uint16)
    for img in (rgb[:48, :64], ir[:48, :64], rgb[:48, :64, 0]):
        assert np.array_equal(cal.remap(img, m1, m2),
                              cv2.remap(img, m1, m2, interpolation=cv2.INTER_LINEAR))


def _tie_rule(got, want, u32, v32):
    """Entries may differ only where u·32 or v·32 lies within 1e-6 of a
    rounding tie, and there by one 1/32 step."""
    gu = got[0][..., 0].astype(np.int64) * 32 + (got[1] & 31)
    gv = got[0][..., 1].astype(np.int64) * 32 + (got[1] >> 5)
    wu = want[0][..., 0].astype(np.int64) * 32 + (want[1] & 31)
    wv = want[0][..., 1].astype(np.int64) * 32 + (want[1] >> 5)
    tie = lambda x: np.abs(x - np.floor(x) - 0.5) < 1e-6  # noqa: E731
    bad = ((gu != wu) & ~(tie(u32) & (np.abs(gu - wu) <= 1))) | \
          ((gv != wv) & ~(tie(v32) & (np.abs(gv - wv) <= 1)))
    return int(bad.sum())


@pytest.mark.parametrize("rotated", [False, True])
def test_rectification_maps_equal_cv2(rotated):
    """Tolerance: ``stereo_rectify``'s matrices within 1e-9 of cv2's (an
    SVD's ulps); the maps equal cv2's except where ``u·32`` or ``v·32`` lies
    within 1e-6 of a rounding tie, and there by at most one 1/32 step (none
    differs on these rigs). The shipped rig and the same rig turned by a
    small rotation, at 1920x1080."""
    import cv2

    left, right, T = _rig()
    R, t = T[:3, :3], T[:3, 3]
    if rotated:
        R, t = cv2.Rodrigues(np.array([0.03, -0.05, 0.02]))[0], np.array([-0.5, 0.02, 0.01])
    want = cv2.fisheye.stereoRectify(left.K, left.D, right.K, right.D, left.resolution, R, t,
                                     cv2.CALIB_ZERO_DISPARITY, fov_scale=1.0, balance=0.0)
    got = cal.stereo_rectify(left.K, left.D, right.K, right.D, left.resolution, R, t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    for cam, r, p in ((left, got[0], got[2]), (right, got[1], got[3])):
        gm = cal.init_undistort_rectify_map(cam.K, cam.D, r, p, left.resolution)
        wm = cv2.fisheye.initUndistortRectifyMap(cam.K, cam.D, r, p, left.resolution,
                                                 cv2.CV_16SC2)
        u = cv2.fisheye.initUndistortRectifyMap(cam.K, cam.D, r, p, left.resolution,
                                                cv2.CV_32FC1)
        assert _tie_rule(gm, wm, u[0].astype(np.float64) * 32,
                         u[1].astype(np.float64) * 32) == 0


def test_stereo_rectifier_equals_jax_on_the_shipped_rig():
    """Tolerance: none; the whole rectifier (maps and frames) at 1920x1080
    equals the JAX ``StereoRectifier`` (cv2), uint8 RGB and uint16."""
    left, right, T = _rig()
    ours = cal.StereoRectifier(left, right, T[:3, :3], T[:3, 3])
    theirs = jcal.StereoRectifier(left, right, T[:3, :3], T[:3, 3])
    for a, b in ((ours.maps_left, theirs.maps_left), (ours.maps_right, theirs.maps_right)):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    np.testing.assert_allclose(ours.Q, theirs.Q, rtol=0, atol=1e-9)
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (1080, 1920, 3)).astype(np.uint8)
    ir = rng.randint(0, 65536, (1080, 1920)).astype(np.uint16)
    for img in (rgb, ir):
        for g, w in zip(ours.rectify(img, img[::-1].copy()), theirs.rectify(img, img[::-1].copy())):
            assert np.array_equal(g, w)


def test_thermal_calib_and_projection_equal_jax():
    """Tolerance: none (the same float64 code)."""
    path = os.path.join(CALIB, "example_rig", "t_calib.json")
    (T, K), (jT, jK) = cal.load_thermal_calib(path), jcal.load_thermal_calib(path)
    assert np.array_equal(T, jT) and np.array_equal(K, jK)
    depth = np.random.RandomState(8).uniform(1, 30, (48, 64)).astype(np.float32)
    left = cal.load_kalibr_yaml(STEREO)["left"]
    assert np.array_equal(cal.project_thermal_to_rgb(depth, left.K, K, T),
                          jcal.project_thermal_to_rgb(depth, left.K, jK, jT))
