"""The port's KAIST loader and its PIL-free decoding against PIL and JAX.

- ``resize_pil`` (bicubic and nearest) and ``convert_l`` against Pillow on
  random and smooth images at the KAIST geometry (640x512 → 256x256), at
  upscales, odd sizes and one-pixel outputs: equal on every pixel;
- palette PNGs (colour type 3, 8 bits) that PIL writes: ``read_png`` gives
  the indices ``np.asarray`` of the PIL image gives, ``convert_l`` with the
  palette PIL's ``convert("L")``;
- ``KAISTCycleGANDataset`` items against ``heatnet_tpu``'s on fresh
  datasets, index by index (the ``RandomState`` draws are per item, B's
  file then the flip; ``batch_iterator``'s producer thread draws ahead, so
  items are not compared through it): on the port's ``make_kaist`` trees
  (PNG bytes) at 64x80 and at KAIST's 640x512, on a tree with palette
  labels, and on the JAX copy's tree, whose ``.jpg`` files are JPEGs (the
  port decodes those with PIL). Labels exact; images equal on every pixel
  (the bound would be 1 count on 0.2 % of pixels: measured 0 % here);
- a JPEG without PIL raises an error that names the file.
"""

import builtins
import os

import numpy as np
import pytest
from PIL import Image

from heatnet_tpu.data import synthetic as jax_synthetic
from heatnet_tpu.data.loaders import KAISTCycleGANDataset as JaxKAIST
from heatnet_tpu_torch.data import loaders
from heatnet_tpu_torch.data.loaders import KAISTCycleGANDataset, convert_l, resize_pil
from heatnet_tpu_torch.data.png import read_png, read_png_palette
from heatnet_tpu_torch.data.synthetic import make_kaist


def _images(seed, h, w):
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (h, w)).astype(np.uint8)
    smooth = np.clip(np.cumsum(rng.randint(-3, 4, (h, w)), 1) + 128, 0, 255).astype(np.uint8)
    return noise, smooth


# (source H, W) x (target W, H): KAIST's 512x640 → 256x256, the synthetic
# trees' 64x80, odd sizes, upscales and one-pixel outputs
SOURCES = [(512, 640), (64, 80), (255, 257), (7, 1000), (1, 5)]
TARGETS = [(256, 256), (80, 64), (13, 700), (256, 1)]


@pytest.mark.parametrize("hw", SOURCES)
def test_resize_pil_equals_pillow(hw):
    for seed, img in enumerate(_images(sum(hw), *hw)):
        for wh in TARGETS:
            for name, mode in (("bicubic", Image.BICUBIC), ("nearest", Image.NEAREST)):
                want = np.asarray(Image.fromarray(img).resize(wh, mode))
                np.testing.assert_array_equal(resize_pil(img, wh, name), want,
                                              err_msg=f"{hw} -> {wh} {name}")
    lbl = np.random.RandomState(1).randint(0, 12, hw).astype(np.int32)
    want = np.asarray(Image.fromarray(lbl).resize((256, 256), Image.NEAREST))
    np.testing.assert_array_equal(resize_pil(lbl, (256, 256), "nearest"), want)


def test_resize_pil_refuses_what_pillow_would_do_otherwise():
    with pytest.raises(ValueError, match="bicubic resize of uint16"):
        resize_pil(np.zeros((4, 4), np.uint16), (2, 2), "bicubic")
    with pytest.raises(ValueError, match="2-D"):
        resize_pil(np.zeros((4, 4, 3), np.uint8), (2, 2), "bicubic")
    with pytest.raises(ValueError, match="resample"):
        resize_pil(np.zeros((4, 4), np.uint8), (2, 2), "bilinear")


def test_convert_l_equals_pillow():
    rng = np.random.RandomState(3)
    for shape in ((50, 60, 3), (50, 60, 4), (50, 60)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(convert_l(img),
                                      np.asarray(Image.fromarray(img).convert("L")))


def test_palette_png_reads_as_its_indices(tmp_path):
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 40, (37, 53)).astype(np.uint8)
    im = Image.fromarray(idx, mode="L").convert("P")
    im.putpalette(rng.randint(0, 256, 3 * 256).astype(np.uint8).tobytes())
    path = str(tmp_path / "p.png")
    im.save(path)
    pil = Image.open(path)
    assert pil.mode == "P"
    pixels, palette = read_png_palette(path)
    np.testing.assert_array_equal(pixels, np.asarray(pil))
    np.testing.assert_array_equal(read_png(path), np.asarray(pil))
    np.testing.assert_array_equal(convert_l(pixels, palette), np.asarray(pil.convert("L")))


def _assert_items_equal(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def _compare(root):
    port, ref = KAISTCycleGANDataset(root, seed=3), JaxKAIST(root, seed=3)
    assert (port.files_A, port.files_B, port.files_label) == \
        (ref.files_A, ref.files_B, ref.files_label)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a = port[i]
        _assert_items_equal(a, ref[i])
    assert a["A"].shape == (256, 256, 1) and a["label"].shape == (256, 256)


@pytest.mark.parametrize("hw,n", [((64, 80), (5, 3)), ((512, 640), (2, 3))])
def test_kaist_items_match_jax(tmp_path, hw, n):
    root = make_kaist(str(tmp_path / "k"), n_day=n[0], n_night=n[1], hw=hw, seed=hw[0])
    _compare(root)


def test_kaist_items_match_jax_on_palette_labels(tmp_path):
    root = make_kaist(str(tmp_path / "k"), n_day=4, n_night=2)
    rng = np.random.RandomState(5)
    for path in KAISTCycleGANDataset(root).files_label:
        im = Image.fromarray(read_png(path), mode="L").convert("P")
        im.putpalette(rng.randint(0, 256, 768).astype(np.uint8).tobytes())
        im.save(path)
        assert Image.open(path).mode == "P"
    _compare(root)


def test_kaist_items_match_jax_on_jpeg_frames(tmp_path):
    """The JAX copy of ``make_kaist`` writes its ``.jpg`` files with cv2,
    as JPEGs: the port hands those to PIL."""
    pytest.importorskip("cv2")
    root = jax_synthetic.make_kaist(str(tmp_path / "k"), n_day=4, n_night=3)
    with open(KAISTCycleGANDataset(root).files_A[0], "rb") as fh:
        assert fh.read(2) == b"\xff\xd8"  # a JPEG
    _compare(root)


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "I00000.jpg")
    with open(path, "wb") as fh:
        fh.write(b"\xff\xd8\xff\xe0 not a PNG")
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match=os.path.basename(path)):
        loaders._read_grey_pil(path)
