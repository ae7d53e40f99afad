"""The port's native C++ runtime (``heatnet_tpu_torch/native``) against JAX's.

Both libraries build here with ``g++``: the port's into
``heatnet_tpu_torch/_build/``, the JAX package's by its own ``get_lib`` from
its own sources and flags, into a temporary directory (its build is not
atomic, and ``tests/test_native.py`` may build it in its package directory
at the same time on another worker). Every function is held to the JAX
package's on the same seeded inputs bit for bit: the relabellers, the
thermal operators, the synchronizer's and the burst sampler's outputs on
seeded random streams, and the message bus's semantics (drop-oldest queues,
the oversized-message ``BufferError``). Also: ``generate_vistas
--use_native`` writes the numpy relabeller's tree, and falls back to it
where the library cannot build; the build's name, place and error.
"""

import os

import numpy as np
import pytest

from heatnet_tpu.data.mappings import VISTAS_TO_HEATNET
from heatnet_tpu.native import bindings as jax_native
from heatnet_tpu_torch.native import bindings as native

RNG_SEED = 0


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    saved = jax_native._SO, jax_native._LIB
    jax_native._SO = str(tmp_path_factory.mktemp("jax_native") / "libheatnet_native.so")
    jax_native._LIB = None
    yield
    jax_native._SO, jax_native._LIB = saved


def _vistas_map(rng, h=40, w=56):
    return (rng.randint(0, 70, (h, w)) * 256 + rng.randint(0, 5, (h, w))).astype(np.uint16)


@pytest.mark.parametrize("fn", ["relabel_vistas_image_native", "relabel_image_native",
                                "thermal_to_8bit", "gray_binarize"])
def test_native_function_equals_jax(fn):
    """Tolerance: none, bit for bit (the same C++ on the same inputs)."""
    rng = np.random.RandomState(RNG_SEED)
    if fn == "relabel_vistas_image_native":
        args = [(_vistas_map(rng), VISTAS_TO_HEATNET), (_vistas_map(rng), {3: 1, 7: 2})]
        kw = [{}, {"background": 9}]
    elif fn == "relabel_image_native":
        args = [(rng.randint(0, 256, (33, 47)).astype(np.uint8),
                 rng.randint(0, 256, (256, 3)).astype(np.uint8))]
        kw = [{}]
    elif fn == "thermal_to_8bit":
        ir = rng.randint(19000, 33000, (51, 64)).astype(np.uint16)
        args = [(ir,), (ir,)]
        kw = [{}, {"trunc_value": 26000.0, "bin_thresh": 60}]
    else:
        g = rng.randint(0, 256, (45, 61)).astype(np.uint8)
        args = [(g,), (g,)]
        kw = [{}, {"thresh": 77}]
    for a, k in zip(args, kw):
        got, want = getattr(native, fn)(*a, **k), getattr(jax_native, fn)(*a, **k)
        for g_, w_ in zip(got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,)):
            assert g_.dtype == w_.dtype and np.array_equal(g_, w_)


def _streams(seed, n_streams=4, n=60):
    """Interleaved pushes of ``n_streams`` streams at about 30 Hz: jittered
    stamps, dropped frames and late arrivals."""
    rng = np.random.RandomState(seed)
    pushes = []
    for s in range(n_streams):
        t = 10.0 + rng.uniform(0, 0.01)
        for i in range(n):
            t += 1 / 30 + rng.normal(0, 0.004)
            if rng.rand() < 0.1:
                continue
            pushes.append((t + rng.uniform(0, 0.02), s, t, 1000 * s + i))
    pushes.sort()
    return [(s, t, fid) for _, s, t, fid in pushes]


def _drive(obj, pushes):
    out = []
    for s, t, fid in pushes:
        obj.push(s, t, fid)
        got = obj.poll()
        if got is not None:
            out.append((got[0].tolist(), got[1].tolist()))
    return out


@pytest.mark.parametrize("kind", ["Synchronizer", "BurstSampler"])
def test_synchronizers_equal_jax_on_random_streams(kind):
    """Tolerance: none; the polled (stamps, ids) tuples equal JAX's, in order."""
    kw = ({"slop_s": 0.012, "max_queue": 20} if kind == "Synchronizer" else
          {"slop_s": 0.012, "max_queue": 20, "burst_period": 0.5, "burst_img_count": 3})
    for seed in (1, 2, 3):
        pushes = _streams(seed)
        got = _drive(getattr(native, kind)(4, **kw), pushes)
        want = _drive(getattr(jax_native, kind)(4, **kw), pushes)
        assert got == want and len(got) > 5


def _bus_trace(mod):
    bus = mod.MessageBus()
    a, b = bus.subscribe("rgb_0", 3), bus.subscribe("rgb_0", 5)
    c = bus.subscribe("ir_0", 2)
    trace = []
    for i in range(7):
        bus.publish("rgb_0", 1.0 + i / 30, f"frame{i}".encode())
        if i % 3 == 0:
            bus.publish("ir_0", 1.0 + i / 30, bytes(range(i + 1)))
    bus.publish("other", 2.0, b"nobody listens")
    trace.append([bus.pending(s) for s in (a, b, c)])
    for s in (a, b, c):
        while True:
            m = bus.poll(s)
            trace.append(m)
            if m is None:
                break
    bus.publish("rgb_0", 3.0, b"x" * 100)
    with pytest.raises(BufferError):
        bus.poll(a, max_len=10)
    trace.append(bus.pending(a))  # the oversized message stays queued
    trace.append(bus.poll(a, max_len=100))
    return trace


def test_message_bus_semantics_equal_jax():
    """Tolerance: none; every poll and count equals JAX's bus."""
    assert _bus_trace(native) == _bus_trace(jax_native)


def test_build_lands_in_build_dir_under_a_hash(tmp_path, monkeypatch):
    """The library is named by a hash of its sources and flags, lives in
    ``heatnet_tpu_torch/_build/``, and a missing ``g++`` raises naming it."""
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libheatnet_native_")
    assert native.build() == path and os.path.isfile(path)
    assert not [f for f in os.listdir(os.path.dirname(native.__file__)) if f.endswith(".so")]
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "lib.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()


def _vistas_root(root):
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(3)
    for d in ("training/images", "v1.2/instances"):
        os.makedirs(os.path.join(root, d))
    for i in range(2):
        write_png(os.path.join(root, f"training/images/s{i}.png"),
                  rng.randint(0, 256, (48, 64, 3)).astype(np.uint8))
        write_png(os.path.join(root, f"v1.2/instances/s{i}.png"), _vistas_map(rng, 48, 64))
    return root


def _tree(root):
    from heatnet_tpu_torch.data.png import read_png

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = (read_png(p) if f.endswith(".png")
                                             else open(p).read())
    return out


def test_generate_vistas_native_writes_the_numpy_tree(tmp_path, monkeypatch, capsys):
    """Tolerance: none; ``--use_native`` (the C++ relabeller) and
    ``--no_native`` write the same files, and a library that cannot build
    leaves the numpy relabeller serving after a message, as in JAX."""
    from heatnet_tpu_torch.cli import generate_vistas

    root = _vistas_root(str(tmp_path / "vistas"))
    calls = []
    real = native.relabel_vistas_image_native
    monkeypatch.setattr(native, "relabel_vistas_image_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for flag, out in (("--use_native", "nat"), ("--no_native", "py")):
        assert generate_vistas.main(["--vistas_root", root, "--out", str(tmp_path / out),
                                     "--width", "32", flag]) == 2
    assert len(calls) == 2
    trees = [_tree(str(tmp_path / d)) for d in ("nat", "py")]
    assert trees[0].keys() == trees[1].keys()
    for k in trees[0]:
        assert np.array_equal(trees[0][k], trees[1][k]), k

    def fail():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "get_lib", fail)
    capsys.readouterr()
    assert generate_vistas.main(["--vistas_root", root, "--out", str(tmp_path / "fb"),
                                 "--width", "32"]) == 2
    assert "native relabeller unavailable (g++ not found)" in capsys.readouterr().out
    assert len(calls) == 2
    fb = _tree(str(tmp_path / "fb"))
    assert all(np.array_equal(fb[k], trees[1][k]) for k in trees[1])
