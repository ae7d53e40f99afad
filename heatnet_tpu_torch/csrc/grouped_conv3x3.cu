// Grouped 3x3 stride-1 'same' convolution, NHWC bf16, f32 sums, with an
// optional per-channel affine + activation epilogue, on Hopper tensor cores.
//
// Replaces the Pallas kernels of heatnet_tpu/ops/pallas_grouped_conv.py:
//   _kernel       (:121-138) via grouped_conv3x3_blockdiag  -> no epilogue
//   _kernel_fused (:141-164) via grouped_conv3x3_fused      -> act(acc*scale+bias)
// and serves the input gradient of the grouped_conv3x3 custom VJP (:297-322),
// which is the same conv of dy with transposed, flipped weight blocks. In
// ResNeXt-50 that is 16 launches per forward (and 16 more for dx in a
// training step), at C / channels-per-group / dilation 128/2/1, 256/4/1,
// 512/8/2 and 1024/16/4.
//
// Formulation: the TPU kernel's block-diagonal taps (_block_diag_taps, :94)
// cut to 16-channel tiles. For each tap t = (ky, kx) and channel tile j,
//   out[p, 16j:16j+16] += x[p + d*(ky-1, kx-1), 16j:16j+16] @ B[t, j]
// where B[t, j] is the 16x16 diagonal block (zero outside a group; every
// cpg in 1/2/4/8/16 divides 16). The tiles are those of
// ops/grouped_conv.py::pack_weight_tiles, tiles[t][j][co][ci]: each warp
// gathers its tile's mma B fragments straight from PyTorch's (C, cpg, 3, 3)
// weight, zeros outside a group, and for dx (flip) each group's block
// transposed and the taps flipped. Gathering in the kernel, once per block
// and channel slice, costs no launch and no bytes beyond the weight; a pack
// on the host added two PyTorch launches per call and held the eager loop
// at mod3 to 0.070 ms against 0.020 ms of card time (PERF.md). Sums stay in
// f32 over the 9 taps and round once.
//
// What bounds it on the H100: bytes. An output costs 9 * 16 * 2 = 288
// executed FLOP (structural zeros included) against 4 bytes moved (x read
// once, out written once), 72 FLOP/byte, under the card's ~295. The CUDA-core
// kernel this replaces spent ~2 instructions per product and was issue-bound
// (3-15x its byte bound); here a warp does a 16-pixel x 16-channel tile's
// 2304 products per tap in 2 instructions.
//
// Design:
//  - mma.sync.m16n8k16 (bf16 in, f32 sums), not wgmma: 72 FLOP/byte needs a
//    fraction of mma.sync's rate, and its 16x8 tiles fit a 16-wide group
//    tile; wgmma's 64-row tiles and shared-memory descriptors buy nothing
//    a byte-bound conv can use. Rows of A are 16 output pixels along W;
//    A comes by ldmatrix.x4 straight from the input halo in shared memory
//    (a tap is an address offset, no im2col buffer), and each warp keeps its
//    channel tile's B fragments for all 9 taps in 36 registers.
//  - A block tile is 8 output rows x 16 columns x 64 channels (4 channel
//    tiles, one per warp pair). Its halo, (8+2d) x (16+2d) pixels x 64
//    channels, comes by TMA from a 4-D tiled map over (C, W, H, N): the
//    coordinates start at (w0-d, h0-d) and may be negative, and out-of-bounds
//    elements are zero-filled, which is the 'same' padding. 64 bf16 = 128
//    bytes is the span of CU_TENSOR_MAP_SWIZZLE_128B, so each pixel is one
//    128-byte line whose 16-byte chunks are XORed with (line % 8): the 8 rows
//    of an ldmatrix (8 consecutive pixels) hit 8 different chunks, free of
//    bank conflicts for every tap shift.
//  - Two halo buffers with an mbarrier each: the next tile loads while the
//    current one multiplies. The grid is persistent (as many blocks as fit
//    on the SMs), each block walking a contiguous run of tiles, channel
//    slice slowest, so B is reloaded only when the slice changes and
//    neighbouring halos are read from L2 moments apart.
//  - Epilogue: act(acc*scale + bias) on the f32 fragments, one rounding to
//    bf16, written into a swizzled shared-memory tile (4-byte stores, free
//    of conflicts), then one TMA store per tile, which also clips the ragged
//    edges (W 88/80, H 40 are not multiples of the tile).
//  - Up to two blocks per SM (128 registers, <= 113 KB of shared memory at
//    d <= 4), one at d >= 4, where fewer halo streams per SM measured faster.
//  - Dilation up to 8 (two 96 KB halos at d = 8); C a multiple of 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;      // output rows per block tile
constexpr int kCols = 16;     // output columns per block tile (one m16 tile)
constexpr int kChans = 64;    // channels per block tile: 128 bytes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMPerWarp = kRows / 2;  // each warp pair splits the 8 rows
constexpr int kMaxDil = 8;
constexpr int kOutBytes = kRows * kCols * kChans * 2;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kElu = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float y, float slope) {
  if (ACT == kRelu) return fmaxf(y, 0.f);
  if (ACT == kLeaky) return y > 0.f ? y : slope * y;
  if (ACT == kElu) return y > 0.f ? y : expm1f(y);
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_halo(const CUtensorMap* map, uint32_t dst,
                                              uint32_t bar, uint32_t bytes, int c,
                                              int w, int h, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h),
         "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x at the lower address
  return *reinterpret_cast<uint32_t*>(&v);
}

// x_map / out_map: (C, W, H, N) bf16 maps, boxes (64, 16+2d, 8+2d, 1) and
// (64, 16, 8, 1), both 128B-swizzled. w: (C, cpg, 3, 3) bf16 bits.
// scale, bias: (C,) f32, read only when AFFINE.
template <bool AFFINE, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
grouped_conv3x3_mma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap out_map,
                           const uint16_t* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, int N, int H, int W,
                           int C, int cpg, int dil, int flip, float slope,
                           int tiles_per_block) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int halo_w = kCols + 2 * dil;
  const int halo_lines = (kRows + 2 * dil) * halo_w;
  const uint32_t halo_bytes = halo_lines * 128;
  const uint32_t halo_stride = (halo_bytes + 1023) & ~1023u;
  const uint32_t halo0 = smem_u32(smem);
  const uint32_t stage = halo0 + 2 * halo_stride;  // output tile, 1024-aligned
  const uint32_t bar0 = stage + kOutBytes;         // two 8-byte mbarriers

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = warp & 3;        // channel tile within the block's 64
  const int row0 = warp >> 2;    // this warp's rows: row0, row0+2, ...

  const int w_tiles = (W + kCols - 1) / kCols;
  const int h_tiles = (H + kRows - 1) / kRows;
  const int spatial = N * h_tiles * w_tiles;
  const int total = spatial * (C / kChans);
  const int first = blockIdx.x * tiles_per_block;
  const int count = min(tiles_per_block, total - first);
  if (count <= 0) return;

  auto coords = [&](int t, int& cs, int& n, int& h0, int& w0) {
    cs = t / spatial;
    int r = t - cs * spatial;
    n = r / (h_tiles * w_tiles);
    r -= n * h_tiles * w_tiles;
    h0 = (r / w_tiles) * kRows;
    w0 = (r % w_tiles) * kCols;
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0 + 8 * s));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < 2 && s < count; ++s) {
      int cs, n, h0, w0;
      coords(first + s, cs, n, h0, w0);
      tma_load_halo(&x_map, halo0 + s * halo_stride, bar0 + 8 * s, halo_bytes,
                    cs * kChans, w0 - dil, h0 - dil, n);
    }
  }
  __syncthreads();

  // ldmatrix.x4 lanes: pixel (lane % 16) of the m16 tile, k half (lane / 16)
  const int a_px = lane & 15;
  const int a_chunk = 2 * j + (lane >> 4);
  const int q = lane & 3;  // fragment column pair
  const int m = lane >> 2; // fragment row

  uint32_t b[9][2][2];
  float2 sc[2], bi[2];
  int cur_cs = -1;

  for (int k = 0; k < count; ++k) {
    int cs, n, h0, w0;
    coords(first + k, cs, n, h0, w0);
    if (cs != cur_cs) {
      cur_cs = cs;
      // B fragment of lane: n = nh*8 + m (output channel of the tile),
      // k = 2q + e + 8*reg (input channel), two k per register, lower first
      const int c16 = (cs * (kChans / 16) + j) * 16;
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
        for (int reg = 0; reg < 2; ++reg) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nh * 8 + m, kk = 2 * q + e + 8 * reg;
            const bool in_group = n / cpg == kk / cpg;
            // forward: w[co, ci % cpg, t]; dx: w[ci, co % cpg, 8 - t]
            const int base = flip ? ((c16 + kk) * cpg + n % cpg) * 9 + 8
                                  : ((c16 + n) * cpg + kk % cpg) * 9;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const uint32_t v = in_group ? __ldg(w + base + (flip ? -t : t)) : 0u;
              b[t][nh][reg] = e ? (b[t][nh][reg] | (v << 16)) : v;
            }
          }
        }
      }
      if (AFFINE) {
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const int ch = cs * kChans + j * 16 + nh * 8 + 2 * q;
          sc[nh] = *reinterpret_cast<const float2*>(scale + ch);
          bi[nh] = *reinterpret_cast<const float2*>(bias + ch);
        }
      }
    }

    const int s = k & 1;
    const uint32_t buf = halo0 + s * halo_stride;
    mbar_wait(bar0 + 8 * s, (k >> 1) & 1);

    float acc[kMPerWarp][2][4];
#pragma unroll
    for (int i = 0; i < kMPerWarp; ++i) {
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][nh][v] = 0.f;
      }
      const int r = row0 + 2 * i;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int line = (r + ky * dil) * halo_w + a_px + kx * dil;
          uint32_t a[4];
          ldmatrix_x4(buf + line * 128 + ((a_chunk ^ (line & 7)) << 4), a);
          mma_bf16(acc[i][0], a, b[ky * 3 + kx][0][0], b[ky * 3 + kx][0][1]);
          mma_bf16(acc[i][1], a, b[ky * 3 + kx][1][0], b[ky * 3 + kx][1][1]);
        }
      }
    }

    // The previous tile's TMA store has read the staging tile; every warp is
    // done with this halo buffer, so the tile after next may load into it.
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && k + 2 < count) {
      int cs2, n2, h2, w2;
      coords(first + k + 2, cs2, n2, h2, w2);
      tma_load_halo(&x_map, buf, bar0 + 8 * s, halo_bytes, cs2 * kChans, w2 - dil,
                    h2 - dil, n2);
    }

#pragma unroll
    for (int i = 0; i < kMPerWarp; ++i) {
      const int r = row0 + 2 * i;
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {  // fragment rows m and m + 8
          float y0 = acc[i][nh][2 * hv], y1 = acc[i][nh][2 * hv + 1];
          if (AFFINE) {
            y0 = y0 * sc[nh].x + bi[nh].x;
            y1 = y1 * sc[nh].y + bi[nh].y;
          }
          const int line = r * kCols + m + 8 * hv;
          const uint32_t addr =
              stage + line * 128 + (((2 * j + nh) ^ (line & 7)) << 4) + 4 * q;
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr),
                       "r"(pack_bf16(activate<ACT>(y0, slope), activate<ACT>(y1, slope)))
                       : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%1, %2, %3, %4}], [%5];\n"
          :: "l"(reinterpret_cast<uint64_t>(&out_map)), "r"(cs * kChans), "r"(w0),
             "r"(h0), "r"(n), "r"(stage)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (C, W, H, N) bf16 map of an NHWC tensor, box (64, box_w, box_h, 1).
bool make_map(CUtensorMap* map, const void* ptr, int N, int H, int W, int C,
              int box_w, int box_h) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChans),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 16;

// Two halos, the output tile, two mbarriers, and slack to align to 1024.
constexpr int smem_bytes(int dil) {
  return 2 * ((((kRows + 2 * dil) * (kCols + 2 * dil) * 128) + 1023) & ~1023) +
         kOutBytes + 16 + 1008;
}

template <bool AFFINE, int ACT>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& out_map,
                   const void* w, const void* scale, const void* bias, int N,
                   int H, int W, int C, int cpg, int dil, int flip, float slope,
                   cudaStream_t stream) {
  auto kern = grouped_conv3x3_mma_kernel<AFFINE, ACT>;
  const int smem = smem_bytes(dil);
  // resident blocks per SM times SMs, found once per device and dilation;
  // the shared-memory limit is raised once, to what the largest dilation needs
  static int slots_cache[kMaxDevices][kMaxDil + 1];
  static bool limit_set[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!limit_set[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kMaxDil));
    if (e != cudaSuccess) return e;
    limit_set[device] = true;
  }
  int& slots = slots_cache[device][dil];
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                            smem)) != cudaSuccess) {
      return e;
    }
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // At d >= 4 (48 KB halos, 3x the output tile) one block per SM ran
    // 13-15 % faster than two; at d <= 2 two blocks ran 2-16 % faster
    // (tools/grouped_conv_variants.py on the H100, PERF.md).
    slots = sms * (dil >= 4 ? 1 : per_sm);
  }
  const long long total = static_cast<long long>(N) * ((H + kRows - 1) / kRows) *
                          ((W + kCols - 1) / kCols) * (C / kChans);
  if (total > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int per_block = static_cast<int>((total + slots - 1) / slots);
  const int grid = static_cast<int>((total + per_block - 1) / per_block);
  kern<<<grid, kThreads, smem, stream>>>(
      x_map, out_map, static_cast<const uint16_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), N, H, W, C,
      cpg, dil, flip, slope, per_block);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x, out: (N, H, W, C) bf16, 16-byte aligned; w: (C, cpg, 3, 3) bf16.
// flip != 0 convolves with dx_weight(w) (each group's block transposed, taps
// flipped): the input gradient when x is dy. scale == bias == nullptr
// selects the epilogue-free kernel (act must be 0). act: 0 none, 1 relu,
// 2 leaky_relu(slope), 3 elu. Returns the launch's error, else
// cudaGetLastError(); the caller raises if it is not 0.
int hn_grouped_conv3x3(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W, int C,
                       int cpg, int dil, int flip, int act, float slope,
                       void* stream) {
  if (C % kChans != 0 || cpg < 1 || 16 % cpg != 0 || dil < 1 || dil > kMaxDil ||
      N < 1 || H < 1 || W < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cuTensorMapEncodeTiled is a driver call and needs a current context; a
  // thread that has launched only through the runtime (autograd's worker,
  // for dx) may have none until cudaSetDevice binds the primary context.
  static thread_local int bound_device = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != bound_device) {
    e = cudaSetDevice(device);
    if (e == cudaSuccess) bound_device = device;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap x_map, out_map;
  if (!make_map(&x_map, x, N, H, W, C, kCols + 2 * dil, kRows + 2 * dil) ||
      !make_map(&out_map, out, N, H, W, C, kCols, kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) {
    e = act == kNone ? launch<false, kNone>(x_map, out_map, w, scale, bias, N, H, W,
                                            C, cpg, dil, flip, slope, s)
                     : cudaErrorInvalidValue;
  } else {
    switch (act) {
      case kNone:
        e = launch<true, kNone>(x_map, out_map, w, scale, bias, N, H, W, C, cpg, dil, flip, slope, s);
        break;
      case kRelu:
        e = launch<true, kRelu>(x_map, out_map, w, scale, bias, N, H, W, C, cpg, dil, flip, slope, s);
        break;
      case kLeaky:
        e = launch<true, kLeaky>(x_map, out_map, w, scale, bias, N, H, W, C, cpg, dil, flip, slope, s);
        break;
      case kElu:
        e = launch<true, kElu>(x_map, out_map, w, scale, bias, N, H, W, C, cpg, dil, flip, slope, s);
        break;
      default:
        e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
