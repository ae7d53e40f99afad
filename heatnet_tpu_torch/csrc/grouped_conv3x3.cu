// Grouped 3x3 stride-1 'same' convolution, NHWC bf16, f32 sums, with an
// optional per-channel affine + activation epilogue.
//
// Replaces the Pallas kernels of heatnet_tpu/ops/pallas_grouped_conv.py:
//   _kernel       (:121-138) via grouped_conv3x3_blockdiag  -> no epilogue
//   _kernel_fused (:141-164) via grouped_conv3x3_fused      -> act(acc*scale+bias)
// In ResNeXtSeg's eval forward the fused form serves conv2 -> bn3 (+act) of
// every bottleneck block (heatnet_tpu/models/layers.py:1285-1315): 16
// launches per ResNeXt-50 forward, at C / channels-per-group / dilation
// 128/2/1, 256/4/1, 512/8/2 and 1024/16/4.
//
// What bounds it on the H100: bytes. At batch 8 one launch moves 29-115 MB
// (x read once, out written once, bf16) and does 0.5-8.3 GFLOP, i.e. at most
// ~72 flops per byte against the card's ~295. The TPU kernel expanded each
// tap into a block-diagonal C x C matrix for the 128x128 MXU, doing 64x the
// useful products in structural zeros; here each output channel sums only
// its own group's 9*cpg products, directly, on CUDA cores. The TPU's row
// chunking (rc, h_pad) was a VMEM artifact and has no counterpart.
//
// Design (simple and right first; wgmma/TMA come later):
//  - A block owns 32 channels (one warp's lanes, a whole number of groups
//    since cpg <= 16 divides 32), 8 output rows (one per warp) and 16 output
//    columns (per thread). Grid: (ceil(W/16), ceil(H/8), N*C/32).
//  - The block stages its zero-padded input halo, (8+2d) x (16+2d) x 32
//    channels of bf16, in shared memory with 16-byte loads, so each input
//    byte leaves device memory about once per block, and its weights as f32
//    in a [tap*cpg + ci][channel] layout (lanes read consecutive words).
//  - Each thread keeps 16 f32 accumulators; per tap and per run of up to 8
//    input channels it loads the weights once and the inputs as one
//    4/8/16-byte vector per output column (lanes of one group read the same
//    address, a broadcast).
//  - The epilogue applies scale/bias and the activation to the f32 sum and
//    rounds once to bf16, as the Pallas kernel does before its write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCB = 32;    // channels per block
constexpr int kRows = 8;   // output rows per block (one per warp)
constexpr int kCols = 16;  // output columns per block (per thread)
constexpr int kThreads = kCB * kRows;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kElu = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if (ACT == kRelu) return fmaxf(y, 0.f);
  if (ACT == kLeaky) return y > 0.f ? y : slope * y;
  if (ACT == kElu) return y > 0.f ? y : expm1f(y);
  return y;
}

__device__ __forceinline__ void unpack2(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);  // the lower address holds element 0
  v[1] = __uint_as_float(u & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), v);
  } else if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, v);
    unpack2(u.y, v + 2);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, v);
    unpack2(u.y, v + 2);
    unpack2(u.z, v + 4);
    unpack2(u.w, v + 6);
  }
}

// x: (N, H, W, C) bf16; w: (C, CPG, 3, 3) bf16 (PyTorch's grouped layout);
// scale, bias: (C,) f32, read only when AFFINE; out: (N, H, W, C) bf16.
template <int CPG, bool AFFINE, int ACT>
__global__ void __launch_bounds__(kThreads)
grouped_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H, int W, int C,
                       int dil, float slope) {
  constexpr int VEC = CPG < 8 ? CPG : 8;
  constexpr int KW = 9 * CPG;  // weights per output channel
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [KW][kCB]
  __nv_bfloat16* x_s =
      reinterpret_cast<__nv_bfloat16*>(smem + KW * kCB * sizeof(float));

  const int tid = threadIdx.x;
  const int lane = tid % kCB;
  const int warp = tid / kCB;
  const int slices = C / kCB;
  const int n = blockIdx.z / slices;
  const int c0 = (blockIdx.z - n * slices) * kCB;
  const int h0 = blockIdx.y * kRows;
  const int w0 = blockIdx.x * kCols;
  const int cols_p = kCols + 2 * dil;
  const int rows_p = kRows + 2 * dil;

  const __nv_bfloat16* wb = w + static_cast<long long>(c0) * KW;
  for (int e = tid; e < kCB * KW; e += kThreads) {
    const int co = e / KW;
    const int r = e - co * KW;
    const int ci = r / 9;
    const int tap = r - ci * 9;
    w_s[(tap * CPG + ci) * kCB + co] = __bfloat162float(wb[e]);
  }

  // The halo: each position holds the block's 32 channels as 4 x 16 bytes.
  const int items = rows_p * cols_p * 4;
  for (int it = tid; it < items; it += kThreads) {
    const int pos = it >> 2;
    const int q = it & 3;
    const int r = pos / cols_p;
    const int c = pos - r * cols_p;
    const int gh = h0 - dil + r;
    const int gw = w0 - dil + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
      v = *reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(n) * H + gh) * W + gw) * C + c0 + q * 8);
    }
    *reinterpret_cast<uint4*>(x_s + pos * kCB + q * 8) = v;
  }
  __syncthreads();

  const int gbase = (lane / CPG) * CPG;  // this lane's group, within the block
  float acc[kCols];
#pragma unroll
  for (int p = 0; p < kCols; ++p) acc[p] = 0.f;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const __nv_bfloat16* xr =
          x_s + ((warp + ky * dil) * cols_p + kx * dil) * kCB + gbase;
      const float* wt = w_s + (ky * 3 + kx) * CPG * kCB + lane;
#pragma unroll
      for (int cc = 0; cc < CPG; cc += VEC) {
        float wv[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = wt[(cc + v) * kCB];
#pragma unroll
        for (int p = 0; p < kCols; ++p) {
          float xv[VEC];
          load_bf16<VEC>(xr + p * kCB + cc, xv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[p] = fmaf(wv[v], xv[v], acc[p]);
        }
      }
    }
  }

  const int oh = h0 + warp;
  if (oh >= H) return;
  const int co = c0 + lane;
  float s = 1.f, b = 0.f;
  if (AFFINE) {
    s = scale[co];
    b = bias[co];
  }
  __nv_bfloat16* orow =
      out + (static_cast<long long>(n) * H + oh) * W * static_cast<long long>(C) + co;
#pragma unroll
  for (int p = 0; p < kCols; ++p) {
    const int ow = w0 + p;
    if (ow < W) {
      float y = acc[p];
      if (AFFINE) y = y * s + b;
      orow[static_cast<long long>(ow) * C] = __float2bfloat16_rn(activate<ACT>(y, slope));
    }
  }
}

template <int CPG, bool AFFINE, int ACT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int N, int H, int W, int C,
                   int dil, float slope, cudaStream_t stream) {
  auto kern = grouped_conv3x3_kernel<CPG, AFFINE, ACT>;
  const size_t smem = 9 * CPG * kCB * sizeof(float) +
                      static_cast<size_t>(kRows + 2 * dil) * (kCols + 2 * dil) *
                          kCB * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows,
                  static_cast<unsigned>(N) * (C / kCB));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, C, dil, slope);
  return cudaSuccess;
}

template <int CPG>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int N, int H, int W, int C,
                     int dil, int act, float slope, cudaStream_t s) {
  if (scale == nullptr) {
    if (act != kNone) return cudaErrorInvalidValue;
    return launch<CPG, false, kNone>(x, w, scale, bias, out, N, H, W, C, dil, slope, s);
  }
  switch (act) {
    case kNone:
      return launch<CPG, true, kNone>(x, w, scale, bias, out, N, H, W, C, dil, slope, s);
    case kRelu:
      return launch<CPG, true, kRelu>(x, w, scale, bias, out, N, H, W, C, dil, slope, s);
    case kLeaky:
      return launch<CPG, true, kLeaky>(x, w, scale, bias, out, N, H, W, C, dil, slope, s);
    case kElu:
      return launch<CPG, true, kElu>(x, w, scale, bias, out, N, H, W, C, dil, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// scale == bias == nullptr selects the epilogue-free kernel (act must be 0).
// act: 0 none, 1 relu, 2 leaky_relu(slope), 3 elu. Returns the launch's
// error, else cudaGetLastError(); the caller raises if it is not 0.
int hn_grouped_conv3x3(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W, int C,
                       int cpg, int dil, int act, float slope, void* stream) {
  if (C % kCB != 0 || dil < 1 || N < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (cpg) {
    case 2: e = dispatch<2>(x, w, scale, bias, out, N, H, W, C, dil, act, slope, s); break;
    case 4: e = dispatch<4>(x, w, scale, bias, out, N, H, W, C, dil, act, slope, s); break;
    case 8: e = dispatch<8>(x, w, scale, bias, out, N, H, W, C, dil, act, slope, s); break;
    case 16: e = dispatch<16>(x, w, scale, bias, out, N, H, W, C, dil, act, slope, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
