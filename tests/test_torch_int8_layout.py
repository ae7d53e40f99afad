"""The int8 conv kernel's layouts against the JAX package, on the CPU.

``csrc/int8_conv.cu`` runs only on the card; what it indexes is kept in
``ops/int8_conv.py`` where these tests reach it:

- ``quantize_padded``, the plain version of its first pass (int8 NHWC, each
  block's channels zero-padded to a multiple of 32), equals JAX's
  ``clip(round(x / x_scale), -127, 127).astype(int8)`` (layers.py:862-863)
  bit for bit, on zeros, -0, exact .5 ties and saturating values;
- a packed reference, written here as the kernel forms its int32 sums (per
  128-pixel tile, the taps ``tile_taps`` keeps, each tap's channels in
  128-wide K steps of the padded activation against ``pack_weight``'s rows),
  equals ``int8_sums_plain`` at the layer kinds of the card tests'
  ``INT8_CASES`` (small sizes), with the kernel's tiles of 128 and 256
  pixels, and, dequantized, JAX's ``Int8Conv`` /
  ``GroupedConvDense`` on JAX's weights and calibrated scale, bit for bit,
  at one kind per JAX code path and per padding of the layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatnet_tpu.models.layers import conv as jax_conv
from heatnet_tpu.ops.quant import calibrate_int8 as jax_calibrate
from heatnet_tpu_torch.io.from_jax import state_dict_from_jax
from heatnet_tpu_torch.models import layers as L
from heatnet_tpu_torch.ops import int8_conv
from heatnet_tpu_torch.ops.quant import convert_int8

torch.set_num_threads(2)


@pytest.fixture
def int8_env(monkeypatch):
    monkeypatch.setenv("HEATNET_QUANT", "int8")
    monkeypatch.setenv("HEATNET_INT8_MIN_BATCH", "2")
    monkeypatch.setenv("HEATNET_QUANT_MAX_HW", "100000")


@pytest.mark.parametrize("c,groups", [(269, 1), (64, 1), (256, 64)])
def test_quantize_padded_equals_jax(c, groups):
    rng = np.random.RandomState(c)
    x_scale = np.float32(0.5)
    # multiples of 1/8 (bf16-exact), so x / 0.5 hits exact .5 ties; tails
    # past 127 * 0.5 saturate; a fifth zeros and a tenth -0
    x = (rng.randint(-800, 801, (2, 5, 7, c)) / 8).astype(np.float32)
    x[rng.rand(*x.shape) < 0.2] = 0.0
    x[rng.rand(*x.shape) < 0.1] = -0.0
    x[0, 0, 0, :4] = [0.25, 0.75, -1.25, 63.75]  # ties: 0, 2, -2, 128 -> 127
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / x_scale), -127, 127)
                      .astype(jnp.int8))
    assert (np.abs(want) == 127).any() and (want == 0).mean() > 0.25

    got = int8_conv.quantize_padded(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    torch.tensor(x_scale), groups).numpy()
    cin_g = c if groups == 1 else int8_conv.BLOCK
    cin_pad = -(-cin_g // int8_conv.CHAN_ALIGN) * int8_conv.CHAN_ALIGN
    assert got.dtype == np.int8 and got.shape == (2, 5, 7, (c // cin_g) * cin_pad)
    blocks = got.reshape(2, 5, 7, c // cin_g, cin_pad)
    np.testing.assert_array_equal(blocks[..., :cin_g].reshape(want.shape), want)
    assert not blocks[..., cin_g:].any()


def packed_sums(xq, w_pack, n, h, w, ho, wo, groups, cout_g, k, s, p, d, tile):
    """int32 sums ``(N, Ho, Wo, blocks * cout_g)`` as the kernel forms them,
    ``tile`` output pixels at a time: K_STEP-wide steps of K = (ky, kx, ci),
    one tap's at a time where cin_pad is a multiple of K_STEP, else across
    taps over the kernel rows ``tile_taps`` keeps; ``p`` the padding, an int
    or (height, width)."""
    ph, pw = int8_conv.pad_hw(p)
    blocks = w_pack.shape[0]
    cin_pad = xq.shape[-1] // blocks
    step = int8_conv.K_STEP
    m = n * ho * wo
    xf = xq.to(torch.float64).view(n, h, w, blocks, cin_pad)
    wf = w_pack.to(torch.float64)
    out = torch.zeros((m, blocks, cout_g), dtype=torch.float64)
    skipped = 0
    for m0 in range(0, m, tile):
        rows = torch.arange(m0, min(m0 + tile, m))
        img, rem = rows // (ho * wo), rows % (ho * wo)
        oy, ox = rem // wo, rem % wo
        kys, kxs = int8_conv.tile_taps(m0, m, ho, wo, h, w, k, k, s, (ph, pw), d, tile)
        if cin_pad % step:
            kxs = range(k)  # across taps: whole kernel rows only
        skipped += k * k - len(kys) * len(kxs)

        def a_piece(tap, ci):  # the 16 channels at ci of tap's pixels
            iy, ix = oy * s - ph + (tap // k) * d, ox * s - pw + (tap % k) * d
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            a = torch.zeros((len(rows), blocks, 16), dtype=torch.float64)
            a[ok] = xf[img[ok], iy[ok], ix[ok], :, ci:ci + 16]
            return a

        if cin_pad % step == 0:
            ks = [(ky * k + kx) * cin_pad + c0 for ky in kys for kx in kxs
                  for c0 in range(0, cin_pad, step)]
            k_end = None
        else:
            k_row = k * cin_pad
            ks = list(range(kys.start * k_row, kys.stop * k_row, step)) if kys else []
            k_end = kys.stop * k_row
        acc = torch.zeros((len(rows), blocks, wf.shape[1]), dtype=torch.float64)
        for k0 in ks:
            for q in range(0, step, 16):
                kk = k0 + q
                if (k_end is not None and kk >= k_end) or kk >= wf.shape[2]:
                    continue
                acc += torch.einsum("rbc,bnc->rbn", a_piece(kk // cin_pad, kk % cin_pad),
                                    wf[:, :, kk:kk + 16])
        out[m0:m0 + len(rows)] = acc[..., :cout_g]
    return out.to(torch.int32).view(n, ho, wo, blocks * cout_g), skipped


# (N, Cin, Cout, k, stride, dilation, H, W, groups, bias): the layer kinds of
# tests/test_torch_kernels_cuda.py's INT8_CASES at small sizes (stem 3x3,
# strided 1x1, ASPP's dilated 3x3 with a rate beyond the map and with taps
# skipped for whole tiles, the 269-channel decoder and its 13-channel head,
# a 1-channel 1x1, a 7x7 stride 2, the grouped 3x3 at cpg 2/4/8/16)
KINDS = [(2, 64, 64, 3, 1, 1, 6, 7, 1, False), (2, 256, 128, 1, 2, 1, 7, 9, 1, False),
         (2, 512, 256, 3, 1, 12, 5, 6, 1, True), (2, 64, 32, 3, 1, 12, 30, 64, 1, True),
         (2, 269, 269, 3, 1, 1, 5, 6, 1, False), (2, 269, 13, 3, 1, 1, 5, 6, 1, False),
         (2, 256, 1, 1, 1, 1, 4, 5, 1, False), (2, 96, 40, 7, 2, 1, 9, 11, 1, False),
         (2, 128, 128, 3, 1, 1, 4, 5, 64, False), (2, 256, 256, 3, 1, 1, 4, 5, 64, False),
         (2, 512, 512, 3, 1, 2, 4, 5, 64, False), (2, 1024, 1024, 3, 1, 4, 3, 4, 64, False)]
# the kinds held to JAX's layers as well: each JAX code path (Int8Conv plain;
# banded, with the side bands beyond the map and with them skipped for some
# tiles; GroupedConvDense's int8 arm at the least and the most channels per
# group) and each padding of the packed layout (channels 64 and 269, a
# 13-row head); JAX's eager layer costs about 1.4 s a shape on the CPU
JAX_KINDS = [KINDS[i] for i in (0, 2, 3, 5, 8, 11)]


def _packed(x, w_q, x_scale, n, cin, cout, k, s, d, h, w, groups, tile=128, pad=None):
    """The packed reference's sums, NHWC, and how many (tile, tap) K steps
    it skipped; ``pad`` (height, width), 'same' by default."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if pad is None:
        pad = d * (k // 2)
    ho, wo = int8_conv.output_hw(h, w, k, k, s, pad, d)
    cout_g = cout if groups == 1 else int8_conv.BLOCK
    return packed_sums(int8_conv.quantize_padded(xt, x_scale, groups),
                       int8_conv.pack_weight(w_q, groups), n, h, w, ho, wo, groups,
                       cout_g, k, s, pad, d, tile)


@pytest.mark.parametrize("n,cin,cout,k,s,d,h,w,groups,bias", KINDS)
def test_packed_sums_equal_plain(n, cin, cout, k, s, d, h, w, groups, bias):
    rng = np.random.RandomState(cin + k + d)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    w_q, _ = int8_conv.quantize_weight(
        torch.from_numpy(rng.randn(cout, cin // groups, k, k).astype(np.float32)))
    x_scale = torch.tensor(float(np.abs(x).max()) / 100)  # the tails saturate
    plain = int8_conv.int8_sums_plain(torch.from_numpy(x).permute(0, 3, 1, 2), w_q,
                                      x_scale, s, d * (k // 2), d, groups)
    for tile in int8_conv.TILE_M:
        sums, skipped = _packed(x, w_q, x_scale, n, cin, cout, k, s, d, h, w, groups, tile)
        np.testing.assert_array_equal(sums.numpy(), plain.permute(0, 2, 3, 1).numpy())
        if (k, d, h) == (3, 12, 30):
            assert skipped > 0  # the tiles of the top and bottom rows drop a row of taps


# the 3x3 kinds as a frame split by rows runs them (parallel/spatial.py): the
# shard extended by its halo rows, no padding in height, 'same' in width
SHARD_KINDS = [KINDS[i] for i in (0, 3, 4, 8)]


@pytest.mark.parametrize("n,cin,cout,k,s,d,h,w,groups,bias", SHARD_KINDS)
def test_packed_sums_unpadded_in_height_equal_plain(n, cin, cout, k, s, d, h, w, groups,
                                                   bias):
    rng = np.random.RandomState(cin + k + d + 1)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    w_q, _ = int8_conv.quantize_weight(
        torch.from_numpy(rng.randn(cout, cin // groups, k, k).astype(np.float32)))
    x_scale = torch.tensor(float(np.abs(x).max()) / 100)
    pad = (0, d * (k // 2))
    plain = int8_conv.int8_sums_plain(torch.from_numpy(x).permute(0, 3, 1, 2), w_q,
                                      x_scale, s, pad, d, groups)
    assert plain.shape[2] == h - 2 * d * (k // 2) and plain.shape[3] == w
    for tile in int8_conv.TILE_M:
        sums, _ = _packed(x, w_q, x_scale, n, cin, cout, k, s, d, h, w, groups, tile, pad)
        np.testing.assert_array_equal(sums.numpy(), plain.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("n,cin,cout,k,s,d,h,w,groups,bias", JAX_KINDS)
def test_packed_layer_equals_jax(int8_env, n, cin, cout, k, s, d, h, w, groups, bias):
    """Dequantized as the plain version does, the packed sums are JAX's
    int8 layer on its weights and calibrated scale, bit for bit."""
    x = np.random.RandomState(cin + k + d).randn(n, h, w, cin).astype(np.float32)
    pad = d * (k // 2)
    m = jax_conv(cout, k, stride=s, dilation=d, groups=groups, padding=pad,
                 use_bias=bias, dtype=jnp.float32)
    # numpy weights in init's tree (flax's own init costs seconds per shape)
    rng = np.random.RandomState(cout)
    v = {col: jax.tree_util.tree_map(
            lambda a: jnp.asarray((rng.randn(*a.shape) * 0.05 if col == "params"
                                   else np.zeros(a.shape)).astype(a.dtype)), tree)
         for col, tree in jax.eval_shape(m.init, {"params": jax.random.PRNGKey(2)},
                                         jnp.asarray(x)).items()}
    v = jax_calibrate(m.apply, v, [(jnp.asarray(x),)])
    # eager, as tests/test_torch_int8.py holds the layers: under jit XLA
    # turns w_amax / 127.0 into a multiply by 1/127, an ulp off
    want = np.asarray(m.apply(v, jnp.asarray(x)))

    holder = torch.nn.Sequential(L.conv(cin, cout, k, stride=s, dilation=d,
                                        groups=groups, padding=pad, use_bias=bias))
    convert_int8(holder, min_batch=2)
    sd = state_dict_from_jax(v["params"], quant=v["quant"])
    holder.load_state_dict({"0." + k_: t for k_, t in sd.items()}, strict=True)
    layer = holder[0]
    w_q, w_scale = int8_conv.quantize_weight(layer.weight.detach())
    sums, _ = _packed(x, w_q, layer.x_scale, n, cin, cout, k, s, d, h, w, groups)
    bias_t = layer.bias.detach() if bias else None
    got = int8_conv.dequantize(sums.permute(0, 3, 1, 2), torch.float32, w_scale,
                               layer.x_scale, bias_t)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_pack_weight_pads_taps_and_rows_with_zeros():
    w_q, _ = int8_conv.quantize_weight(torch.randn(13, 269, 3, 3))
    pack = int8_conv.pack_weight(w_q)
    assert pack.shape == (1, 64, 9 * 288)
    taps = pack.view(64, 9, 288)
    assert torch.equal(taps[:13, :, :269], w_q.permute(0, 2, 3, 1).reshape(13, 9, 269))
    assert not taps[13:].any() and not taps[:, :, 269:].any()
