// int8 convolution for the int8 serving mode: the activation quantized on
// load, int8 x int8 -> int32 on tensor cores, the dequantisation (and, for
// the grouped convs, bn3's affine + activation) in the epilogue.
//
// Not a TPU kernel. Its JAX counterpart is XLA's
// conv_general_dilated(int8, int8, preferred_element_type=int32) inside
// heatnet_tpu/models/layers.py: Int8Conv (:859-866, dense convs of conv())
// and GroupedConvDense's int8 arm (:531-540, the block-diagonal dense form of
// the grouped 3x3). One kernel serves every int8 layer of ResNeXtSeg: 1x1 at
// stride 1 and 2, 3x3, 3x3 dilated (ASPP's rates 12/24/36), the grouped 3x3
// (64 groups, 2/4/8/16 channels per group) and any other kernel size.
//
// The function, exactly (the plain version is ops/int8_conv.py):
//   x_q  = clip(rint(x / max(x_scale, 1e-12)), -127, 127)   (IEEE division)
//   acc  = sum over taps and input channels of x_q * w_q    (int32, exact)
//   y    = T(T(acc) * T(max(x_scale, 1e-12) * w_scale[co]))  (T = bf16,
//          rounding after every operation as PyTorch's do)
//   y    = T(y + T(bias[co]))                                (if bias)
//   y    = T(act(float(y) * ep_scale[co] + ep_bias[co]))     (if an epilogue)
// Multiplies and adds are __fmul_rn / __fadd_rn so that nvcc does not
// contract them into an FMA that PyTorch's elementwise kernels do not use.
//
// Formulation: an implicit GEMM, M = output pixels (N*Ho*Wo), N = output
// channels, K = (ky, kx, ci). The weight comes pre-quantized and packed by
// ops/int8_conv.py::pack_weight as (blocks, cout_g_pad, k_pad) int8, K in
// (ky, kx, ci) order, zero-padded to multiples of the tiles. A dense conv is
// one block. A grouped conv is C/64 blocks of 64 input and 64 output
// channels whose weight is block-diagonal (zero between groups): the zeros
// add exactly 0 to an int32 sum, so this is the grouped conv, as JAX's
// block-diagonal expansion is.
//
// What bounds it on the H100: the big 1x1 and dilated 3x3 layers are
// operations (int8 at 1979 TOPS), the grouped and strided ones bytes. This
// first kernel is simple: a 128x64 output tile per block of 8 warps, 64-deep
// K steps through two shared-memory buffers (the next step's global loads in
// registers while the current one multiplies), mma.sync m16n8k32 s8. The
// activation is read as bf16 (every model the serving paths run is bf16 on
// the card) and quantized while it is stored to shared memory, so the int8 copy never exists in device memory. Loads are
// 16-byte vectors where the channels of a block are a multiple of 32
// (every ResNeXt layer but the decoder's 269-channel FuseModule, which takes
// the scalar gather).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels per block tile
constexpr int kBN = 64;        // output channels per block tile
constexpr int kBK = 64;        // K per shared-memory step (two mma k32)
constexpr int kLds = kBK + 16; // bytes per shared row: conflict-free fragments
constexpr int kThreads = 256;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kElu = 3 };

struct Params {
  const __nv_bfloat16* x; // (N, H, W, Cin)
  const int8_t* wq;       // (blocks, cout_g_pad, k_pad)
  const float* w_scale;   // (Cout,)
  const float* x_scale;   // () on the device
  const float* bias;      // (Cout,) or null
  const float* ep_scale;  // (Cout,) or null: act(y * ep_scale + ep_bias)
  const float* ep_bias;
  __nv_bfloat16* out;     // (N, Ho, Wo, Cout)
  int n, h, w, cin, ho, wo, cout;
  int kh, kw, stride, pad, dil;
  int cin_g, cout_g, cout_g_pad, k, k_pad, tiles_n, m;
  int act;
  float slope;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the 8 bf16 values of a 16-byte vector
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// __fdiv_rn is the IEEE division JAX's x / scale is. Its fast path does not
// take a zero numerator, so a post-ReLU input (half zeros) costs about twice
// a signed one on the 16-byte path (chip_smoke.py phase 9a measures both).
__device__ __forceinline__ uint32_t quant4(const float* v, float xs) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], xs)), -127.f), 127.f);
    word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * i);
  }
  return word;
}

__device__ __forceinline__ float activate(float y, int act, float slope) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kLeaky) return y > 0.f ? y : __fmul_rn(y, slope);
  if (act == kElu) return y > 0.f ? y : expm1f(y);
  return y;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// VEC: a thread's 32 consecutive K lie in one tap and are 32 consecutive
// channels (cin_g % 32 == 0): four 16-byte loads.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][kBM * kLds];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int g = lane >> 2, tig = lane & 3;
  const int blk = blockIdx.y / p.tiles_n;
  const int n0 = (blockIdx.y - blk * p.tiles_n) * kBN;
  const int m0 = blockIdx.x * kBM;
  const float xs = fmaxf(*p.x_scale, 1e-12f);

  // this thread's A row (one output pixel) and its 32 of the 64 K of a step
  const int a_row = tid >> 1, a_k = (tid & 1) * 32;
  const int m = m0 + a_row;
  const bool m_ok = m < p.m;
  int img = 0, oy = 0, ox = 0;
  if (m_ok) {
    img = m / (p.ho * p.wo);
    const int r = m - img * p.ho * p.wo;
    oy = r / p.wo;
    ox = r - oy * p.wo;
  }
  const int iy0 = oy * p.stride - p.pad, ix0 = ox * p.stride - p.pad;
  const __nv_bfloat16* xb =
      p.x + static_cast<size_t>(img) * p.h * p.w * p.cin + blk * p.cin_g;
  // this thread's 16 bytes of the B tile
  const int b_row = tid >> 2, b_k = (tid & 3) * 16;
  const int8_t* wb = p.wq + (static_cast<size_t>(blk) * p.cout_g_pad + n0 + b_row) *
                               p.k_pad + b_k;

  constexpr int kVec = 4;
  uint4 araw[VEC ? kVec : 1];
  float asc[VEC ? 1 : 32];
  bool a_valid = false;
  uint4 braw;

  auto load = [&](int kt) {
    const int k0 = kt * kBK + a_k;
    if constexpr (VEC) {
      a_valid = false;
      if (m_ok && k0 < p.k) {
        const int tap = k0 / p.cin_g, ci = k0 - tap * p.cin_g;
        const int ky = tap / p.kw, kx = tap - ky * p.kw;
        const int iy = iy0 + ky * p.dil, ix = ix0 + kx * p.dil;
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
          const uint4* src = reinterpret_cast<const uint4*>(
              xb + (static_cast<size_t>(iy) * p.w + ix) * p.cin + ci);
#pragma unroll
          for (int i = 0; i < kVec; ++i) araw[i] = __ldg(src + i);
          a_valid = true;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k = k0 + i;
        float v = 0.f;
        if (m_ok && k < p.k) {
          const int tap = k / p.cin_g, ci = k - tap * p.cin_g;
          const int ky = tap / p.kw, kx = tap - ky * p.kw;
          const int iy = iy0 + ky * p.dil, ix = ix0 + kx * p.dil;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
            v = __bfloat162float(xb[(static_cast<size_t>(iy) * p.w + ix) * p.cin + ci]);
        }
        asc[i] = v;
      }
    }
    braw = __ldg(reinterpret_cast<const uint4*>(wb + kt * kBK));
  };

  auto store = [&](int buf) {
    uint32_t words[8];
    if constexpr (VEC) {
      if (a_valid) {
        float f[32];
#pragma unroll
        for (int i = 0; i < kVec; ++i) unpack(araw[i], f + 8 * i);
#pragma unroll
        for (int i = 0; i < 8; ++i) words[i] = quant4(f + 4 * i, xs);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) words[i] = 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) words[i] = quant4(asc + 4 * i, xs);
    }
    uint4* dst = reinterpret_cast<uint4*>(&As[buf][a_row * kLds + a_k]);
    dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
    dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
    *reinterpret_cast<uint4*>(&Bs[buf][b_row * kLds + b_k]) = braw;
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = p.k_pad / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* base = &As[cur][(wm * 32 + mt * 16 + g) * kLds + ks + tig * 4];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* base = &Bs[cur][(wn * 32 + nt * 8 + g) * kLds + ks + tig * 4];
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2*tig, 2*tig+1; c2, c3 at row g+8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (row >= p.m || col >= p.cout_g) continue;
        const int co = blk * p.cout_g + col;
        const float s = round_bf16(__fmul_rn(xs, p.w_scale[co]));
        float y = round_bf16(__int2float_rn(acc[mt][nt][e]));
        y = round_bf16(__fmul_rn(y, s));
        if (p.bias != nullptr) y = round_bf16(__fadd_rn(y, round_bf16(p.bias[co])));
        if (p.ep_scale != nullptr)
          y = activate(__fadd_rn(__fmul_rn(y, p.ep_scale[co]), p.ep_bias[co]), p.act,
                       p.slope);
        p.out[static_cast<size_t>(row) * p.cout + co] = __float2bfloat16_rn(y);
      }
    }
  }
}

cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.cout / p.cout_g) * p.tiles_n);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec) {
    int8_conv_kernel<true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    int8_conv_kernel<false><<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) bf16; out: (N, Ho, Wo, Cout) bf16; w: (Cout / cout_g blocks, cout_g_pad, k_pad) int8 from pack_weight,
// k = kh*kw*cin_g (ky, kx, ci order); w_scale (Cout,), x_scale () f32 on the
// device; bias, ep_scale and ep_bias (Cout,) f32 or null (ep_scale and
// ep_bias together). act: 0 none, 1 relu, 2 leaky_relu(slope), 3 elu.
// Returns the launch's error, else cudaGetLastError(); the caller raises if
// it is not 0.
int hn_int8_conv(const void* x, const void* w, const void* w_scale,
                 const void* x_scale, const void* bias, const void* ep_scale,
                 const void* ep_bias, void* out, int n, int h, int wd, int cin,
                 int ho, int wo, int cout, int kh, int kw, int stride, int pad,
                 int dil, int cin_g, int cout_g, int cout_g_pad, int k_pad,
                 int act, float slope, void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  const int k = kh * kw * cin_g;
  if (n < 1 || ho < 1 || wo < 1 || cin_g < 1 || cout_g < 1 || cin % cin_g != 0 ||
      cout % cout_g != 0 || cin / cin_g != cout / cout_g || cout_g_pad % kBN != 0 ||
      cout_g_pad < cout_g || k_pad % kBK != 0 || k_pad < k || m > (1ll << 31) - 1 ||
      (ep_scale == nullptr) != (ep_bias == nullptr) || act < kNone || act > kElu ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wq = static_cast<const int8_t*>(w);
  p.w_scale = static_cast<const float*>(w_scale);
  p.x_scale = static_cast<const float*>(x_scale);
  p.bias = static_cast<const float*>(bias);
  p.ep_scale = static_cast<const float*>(ep_scale);
  p.ep_bias = static_cast<const float*>(ep_bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n = n; p.h = h; p.w = wd; p.cin = cin; p.ho = ho; p.wo = wo; p.cout = cout;
  p.kh = kh; p.kw = kw; p.stride = stride; p.pad = pad; p.dil = dil;
  p.cin_g = cin_g; p.cout_g = cout_g; p.cout_g_pad = cout_g_pad; p.k = k;
  p.k_pad = k_pad; p.tiles_n = cout_g_pad / kBN; p.m = static_cast<int>(m);
  p.act = act; p.slope = slope;
  const bool vec = cin_g % 32 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch(p, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
