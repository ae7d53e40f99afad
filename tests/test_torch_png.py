"""The port's PNG codec, resize and eval loaders against cv2 and the JAX loaders.

``heatnet_tpu_torch.data.png`` decodes what cv2 writes (libpng, every row
filter) to the same arrays as ``cv2.imread``, and what it writes cv2 reads
back unchanged. ``data.loaders.resize`` is held to ``cv2.resize``: NEAREST
and uint8 LINEAR exactly, uint16 LINEAR within 1 count on the shares of
pixels measured here (all below 1 %). Each eval loader of the port returns
the JAX loader's items on trees written by cv2 (``heatnet_tpu.data.synthetic``);
at the 960x320 source size the resize is the identity and every array is
exactly equal.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from heatnet_tpu.data import loaders as jax_loaders
from heatnet_tpu.data import synthetic
from heatnet_tpu_torch.data import loaders
from heatnet_tpu_torch.data.png import read_png, write_png

ALL_FILTERS = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]
MODES = {"grey8": ((), np.uint8), "rgb8": ((3,), np.uint8),
         "rgba8": ((4,), np.uint8), "grey16": ((), np.uint16)}


def _image(mode, content, h=61, w=97, seed=0):
    extra, dtype = MODES[mode]
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    if content == "random":
        return rng.randint(0, top + 1, (h, w) + extra).astype(dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    base = xx * 0.3 + yy * 0.7 + 20 * np.sin(xx / 5.0) + rng.randint(0, 3, (h, w))
    if extra:
        base = np.stack([base + 30 * k for k in range(extra[0])], axis=-1)
    return (base * (top / 255.0) / 2).astype(dtype)


def _cv2_order(a):
    """cv2's BGR(A) → RGB(A)."""
    if a.ndim == 3:
        return a[..., [2, 1, 0, 3][:a.shape[2]]] if a.shape[2] == 4 else a[..., ::-1]
    return a


def _row_filters(path):
    data, pos, idat = open(path, "rb").read(), 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


@pytest.fixture(scope="module")
def cv2_pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    files = {}
    for mode in MODES:
        for content in ("random", "smooth"):
            img = _image(mode, content)
            path = str(d / f"{mode}_{content}.png")
            # cv2 stores BGR(A): hand it the channel order it will reverse
            assert cv2.imwrite(path, _cv2_order(img), ALL_FILTERS)
            files[(mode, content)] = (path, img)
    return files


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("content", ["random", "smooth"])
def test_decoder_equals_cv2(cv2_pngs, mode, content):
    path, img = cv2_pngs[(mode, content)]
    got = read_png(path)
    want = _cv2_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert got.dtype == want.dtype and got.shape == want.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_cv2_files_hold_all_five_row_filters(cv2_pngs):
    seen = set().union(*(_row_filters(p) for p, _ in cv2_pngs.values()))
    assert seen == {0, 1, 2, 3, 4}
    # a random image alone holds Average and Paeth rows, the sequential ones
    assert {3, 4} <= _row_filters(cv2_pngs[("rgb8", "random")][0])


@pytest.mark.parametrize("mode", list(MODES))
def test_writer_round_trips_through_cv2(tmp_path, mode):
    img = _image(mode, "random", seed=1)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(_cv2_order(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img)
    np.testing.assert_array_equal(read_png(path), img)
    assert _row_filters(path) == {0}


@pytest.mark.parametrize("choice", ["none", "sub", "up", "average", "paeth", "adaptive"])
def test_decoder_reads_every_row_filter_of_the_timing_tool(tmp_path, choice):
    from heatnet_tpu_torch.tools.png_decode_time import write_filtered

    for mode in ("rgb8", "grey16"):
        img = _image(mode, "smooth", h=23, w=41, seed=3)
        path = str(tmp_path / f"{mode}.png")
        kinds = write_filtered(path, img, choice)
        assert sum(kinds) == 23
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(_cv2_order(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img)


def test_writer_refuses_what_it_does_not_write(tmp_path):
    for bad in (np.zeros(5, np.uint8), np.zeros((2, 2, 2), np.uint8),
                np.zeros((2, 2, 3), np.uint16), np.zeros((2, 2), np.float32)):
        with pytest.raises(ValueError, match="cannot write"):
            write_png(str(tmp_path / "x.png"), bad)


def test_decoder_refuses_what_it_does_not_read(tmp_path):
    rng = np.random.RandomState(2)
    # a palette at 4 bits per index (8-bit palettes are read, see below)
    for pil_mode, shape, bits in (("P", (8, 8), 4), ("LA", (8, 8, 2), None),
                                  ("1", (8, 8), None)):
        path = str(tmp_path / f"{pil_mode}.png")
        Image.fromarray(rng.randint(0, 2, shape).astype(np.uint8) * 255).convert(
            pil_mode).save(path, **({"bits": bits} if bits else {}))
        with pytest.raises(ValueError, match="not supported"):
            read_png(path)
    # the same bytes as a good file, marked interlaced (Adam7)
    path = str(tmp_path / "good.png")
    write_png(path, rng.randint(0, 255, (8, 8)).astype(np.uint8))
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


# (source H, W) → (target W, H): the Freiburg, MFNet-like and BDD-like
# geometries, odd sizes, and an upscale from the synthetic trees' size
SIZES = [((650, 1920), (960, 320)), ((512, 640), (960, 320)), ((720, 1280), (704, 320)),
         ((64, 192), (960, 320)), ((100, 77), (640, 480)), ((48, 96), (704, 320))]
# uint16 LINEAR: the share of pixels 1 count from cv2, as measured, for
# uniform random counts and for a smooth ramp (cv2 breaks exact .5 ties
# another way on these)
U16_SHARE = {0: (0.0, 0.0), 1: (0.00143, 0.0), 2: (0.00032, 0.0), 3: (0.0, 0.0),
             4: (0.0008, 0.00056), 5: (0.00055, 0.0)}


def _resize_inputs(i, dtype, channels=3):
    (h, w), _ = SIZES[i]
    rng = np.random.RandomState(10 + i)
    if dtype == np.uint16:
        return rng.randint(21000, 26000, (h, w)).astype(np.uint16)
    return rng.randint(0, 256, (h, w, channels)).astype(np.uint8)


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_resize_nearest_equals_cv2(i):
    wh = SIZES[i][1]
    for img in (_resize_inputs(i, np.uint8)[..., 0], _resize_inputs(i, np.uint16)):
        np.testing.assert_array_equal(loaders.resize(img, wh, nearest=True),
                                      cv2.resize(img, wh, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_resize_linear_uint8_equals_cv2(i):
    wh = SIZES[i][1]
    for img in (_resize_inputs(i, np.uint8), _resize_inputs(i, np.uint8)[..., 1]):
        np.testing.assert_array_equal(loaders.resize(img, wh),
                                      cv2.resize(img, wh, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_resize_linear_uint16_within_one_count_of_cv2(i):
    (h, w), wh = SIZES[i]
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = (21000 + 3 * xx + 2 * yy).astype(np.uint16)
    for img, want in zip((_resize_inputs(i, np.uint16), ramp), U16_SHARE[i]):
        diff = np.abs(loaders.resize(img, wh).astype(np.int64)
                      - cv2.resize(img, wh, interpolation=cv2.INTER_LINEAR).astype(np.int64))
        share = float((diff > 0).mean())
        assert diff.max() <= 1 and share <= 0.01
        assert share == pytest.approx(want, abs=5e-5), share


def test_resize_to_the_same_size_is_a_copy():
    img = _resize_inputs(0, np.uint8)
    out = loaders.resize(img, (img.shape[1], img.shape[0]))
    assert out is not img and np.array_equal(out, img)


def _assert_items_equal(port, ref, exact):
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        if exact or k == "label" or port[k].dtype == np.uint8:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        elif port[k].dtype == np.uint16:
            d = np.abs(port[k].astype(np.int64) - ref[k].astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, k
        else:  # ir_org: the clamped IR / 3200, one count apart at most
            np.testing.assert_allclose(port[k], ref[k], atol=1.01 / 3200, err_msg=k)


@pytest.mark.parametrize("hw", [(64, 192), (320, 960)], ids=["resized", "identity"])
def test_freiburg_loaders_match_jax(tmp_path, hw):
    test_root = synthetic.make_freiburg_test(str(tmp_path / "test"), n=2, hw=hw)
    paths = loaders.get_test_paths([test_root])
    assert paths == jax_loaders.get_test_paths([test_root])
    assert loaders.get_test_stamps(paths[2]) == jax_loaders.get_test_stamps(paths[2])
    port, ref = loaders.FreiburgThermalTestDataset(*paths), \
        jax_loaders.FreiburgThermalTestDataset(*paths)
    assert len(port) == len(ref) == 2
    for i in range(2):
        _assert_items_equal(port[i], ref[i], exact=hw == (320, 960))

    infer_root = synthetic.make_freiburg_infer(str(tmp_path / "infer"), n=3, hw=hw)
    port, ref = loaders.FreiburgInferDataset(infer_root), \
        jax_loaders.FreiburgInferDataset(infer_root)
    assert port.ir_files == ref.ir_files
    assert [loaders.stamp_sort_key(f) for f in port.ir_files] == \
        [jax_loaders.stamp_sort_key(f) for f in ref.ir_files]
    items = list(loaders.prefetch_items(port, workers=2, depth=2))
    assert len(items) == 3
    for i in range(3):
        _assert_items_equal(items[i], ref[i], exact=hw == (320, 960))


@pytest.mark.parametrize("hw", [(48, 64), (480, 640)], ids=["resized", "identity"])
def test_mfnet_loader_matches_jax(tmp_path, hw):
    root = synthetic.make_mfnet(str(tmp_path / "mf"), n_train=0, n_test=2, hw=hw)
    for split in ("day", "night", "combined"):
        port, ref = loaders.MFNetDataset(root, split), jax_loaders.MFNetDataset(root, split)
        assert port.names == ref.names
        for i in range(len(ref)):
            # host-normalised floats of uint8 frames: exact either way
            _assert_items_equal(port[i], ref[i], exact=True)
    with pytest.raises(ValueError):
        loaders.MFNetDataset(root, split="dusk")


def test_bdd_loader_matches_jax(tmp_path):
    root = synthetic.make_bdd(str(tmp_path / "bdd"))
    port, ref = loaders.BDDValDataset(root), jax_loaders.BDDValDataset(root)
    assert len(port) == len(ref) == 2
    for i in range(2):
        _assert_items_equal(port[i], ref[i], exact=True)
        assert 255 in np.unique(port[i]["label"])
