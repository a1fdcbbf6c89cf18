// Depthwise 3x3 convolution, stride 1, zero padding 1, no bias, NHWC,
// forward and backward:
//   y[p, c]  = round(sum_t x[p + off_t, c] * w[t, c])
//   dx[p, c] = round(sum_t w[t, c] * dy[p - off_t, c])
//   dw[t, c] = round(sum_p x[p + off_t, c] * dy[p, c])
//            = round(sum_q x[q, c] * dy[q - off_t, c])
// taps t = 3*(oy+1) + (ox+1) row-major, off_t = (oy, ox); zero outside the
// image.
//
// Replaces the TPU kernels outgridvit_tpu/ops/experimental/dwconv_pallas_t.py:
// dwconv3x3_t (#10: `_fwd_kernel`, pallas_call at :181; `_bwd_kernel`, :211)
// and dwconv_bwd_pallas.py:dwconv3x3 (#11: its forward is XLA's conv, its
// backward `_bwd_kernel`, :170). The two backwards compute the same function
// in two TPU layouts, so one kernel serves both. Rounding points (round() is
// the cast to the compute type): x, dy and w (already in the compute type)
// read as fp32; the 9 taps summed in fp32 in order, each product rounded
// apart (__fmul_rn / __fadd_rn, as the plain version's separate multiply and
// add); y and dx cast once; dw an fp32 sum over every pixel, cast once to
// w's type.
//
// What bounds it on the H100: 18 flop per element forward (36 backward)
// against 4 bytes moved in bf16 (x read, y written; backward 6: x and dy
// read, dx written): 4.5-6 flop per byte, well below the fp32 pipe's balance
// (67 TFLOP/s over 3.35 TB/s, ~20), so both are bound by bytes. Least time
// at Model B's stage 0 (B = 128, 32x32x256, bf16): backward 201 MB, 60 us;
// at the Tiny-ImageNet stage 0 (64x64x256) 805 MB, 240 us.
//
// Both read the natural NHWC layout (the TPU kernels' transposed [C*H, B*W]
// one would cost two transposes a call).
//
// Forward: a thread handles VEC channels of one pixel with one 16-byte load
// per neighbour, straight from global memory; L1 and L2 serve the re-reads
// of a row by the rows above and below. VEC falls back to 1 where C or a
// pointer does not allow the wide loads (the Python wrapper picks it).
//
// Backward, one kernel cut by a plan made in Python
// (ops/dwconv.py:dwconv3x3_backward_plan), which this file checks:
// - Block (chunk, part) owns `chunk` channels and the part-th run of
//   stages. A stage is `bands` bands; a band is `rows` output rows of one
//   image (at small maps a whole image). For each stage the block copies the
//   halo tile of dy [rows + 2, W + 2, chunk] and the tile of x [rows, W,
//   chunk] into shared memory with 16-byte cp.async, zero-filled (src-size
//   0) outside the image, in two buffers: stage k + 1 loads while stage k
//   computes. Every element comes from device memory once; only dy's two
//   halo rows of a band that is not a whole image are read twice, mostly
//   from L2. x needs no halo: dw is summed as x[q] * dy[q - off_t].
// - A thread owns kCV channels for the whole launch (their 9 weights and 9
//   dw sums stay in registers) and one column of a band at a time, down
//   which it slides a 3x3 window of dy in registers: one new row of 3 reads
//   from shared memory per output pixel, and x at the pixel itself.
// - dx: the taps in the plain version's order, each product and sum rounded
//   apart (__fmul_rn / __fadd_rn), one cast; a warp's stores cover
//   contiguous channels of neighbouring pixels.
// - dw: each thread sums its pixels in fp32, the block sums its threads in
//   a fixed order into one [9, chunk] partial. The plan sets the blocks per
//   chunk so that the partials' bytes (written and read) stay within 10% of
//   x, dy and dx; a second launch sums them in block order (partials.cuh),
//   and with one block per chunk the block writes dw itself. No float
//   atomics: two calls give bitwise-equal dw.
// - Where C or a pointer does not allow 16-byte copies, the same kernel
//   copies and stores one element at a time (VECIO false).
// - Registers: the thread keeps 9*kCV weights, 9*kCV sums and a 9*kCV
//   window. ptxas -v (sm_90a) reports 100 / 104 registers for bf16 (one-
//   element / 16-byte copies) and 108 / 107 for fp32, no spills, under
//   __launch_bounds__(256, 2): two blocks an SM, so the plan keeps a launch
//   to one wave of 264 blocks.
#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kCV = 2;             // channels per thread in the backward
constexpr int kMaxSmem = 232448;   // what one block may ask for

struct Dims {
  int B, H, W, C;
  __host__ __device__ long long pixels() const {
    return static_cast<long long>(B) * H * W;
  }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f32(r.e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  Pack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = r;
}

__device__ __forceinline__ bool inside(int r, int j, const Dims& d) {
  return r >= 0 && r < d.H && j >= 0 && j < d.W;
}

// One thread per (pixel, VEC channels).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dwconv_fwd(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ y, Dims d) {
  const int CV = d.C / VEC;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= d.pixels() * CV) return;
  const int c = static_cast<int>(i % CV) * VEC;
  const long long p = i / CV;
  const int j = static_cast<int>(p % d.W);
  const int r = static_cast<int>((p / d.W) % d.H);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int oy = t / 3 - 1, ox = t % 3 - 1;
    if (!inside(r + oy, j + ox, d)) continue;
    float xv[VEC], wv[VEC];
    load<T, VEC>(x + (p + oy * d.W + ox) * d.C + c, xv);
    load<T, VEC>(w + t * d.C + c, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[e] = __fadd_rn(acc[e], __fmul_rn(xv[e], wv[e]));
    }
  }
  store<T, VEC>(y + p * d.C + c, acc);
}

// The backward's cut (ops/dwconv.py:dwconv3x3_backward_plan).
struct BwdGeom {
  int B, H, W, C;
  int rows, chunk, bands, parts;
  int groups;   // chunk / kCV, a power of two: thread t owns group t % groups
  int gs, cs;   // log2(groups), log2(chunk)
  int nb;       // bands per image: ceil(H / rows)
  int nsub;     // bands in all: B * nb
  int stages;   // ceil(nsub / bands)
  int tile_dy;  // elements of one band's dy tile [rows + 2, W + 2, chunk]
  int tile_x;   // and of its x tile [rows, W, chunk]
};

__host__ __device__ constexpr int ilog2(int v) {
  return v > 1 ? 1 + ilog2(v / 2) : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy stage `st` of channels [c0, c0 + chunk) into `buf`: the bands' dy
// halo tiles, then their x tiles, one tile row per warp at a time. Zeros
// outside the image, past C and past the last band. VECIO: 16-byte
// cp.async; else one element at a time.
template <typename T, bool VECIO>
__device__ void load_stage(const T* __restrict__ x, const T* __restrict__ g,
                           T* buf, int st, int c0, const BwdGeom& d) {
  constexpr int EU = VECIO ? 16 / sizeof(T) : 1;  // elements per copy
  const int qs = d.cs - ilog2(EU);                // log2(copies per pixel)
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int dy_lines = d.bands * (d.rows + 2);
  const int lines = dy_lines + d.bands * d.rows;
  for (int line = warp; line < lines; line += nwarps) {
    const bool isx = line >= dy_lines;
    const int l = isx ? line - dy_lines : line;
    const int trows = isx ? d.rows : d.rows + 2;
    const int halo = isx ? 0 : 1;
    const int s = l / trows;
    const int sb = st * d.bands + s;
    const int b = sb / d.nb;
    const int row = (sb - b * d.nb) * d.rows + (l - s * trows) - halo;
    const bool row_ok = sb < d.nsub && row >= 0 && row < d.H;
    const int cols = isx ? d.W : d.W + 2;
    const T* base = isx ? x : g;
    const T* src_row =
        base + (static_cast<long long>(b) * d.H + row) * d.W * d.C + c0;
    T* dst = buf + (isx ? d.bands * d.tile_dy + l * d.W * d.chunk
                        : l * (d.W + 2) * d.chunk);
    for (int k = threadIdx.x % 32; k < (cols << qs); k += 32) {
      const int col = (k >> qs) - halo, ch = (k & ((1 << qs) - 1)) * EU;
      const bool ok = row_ok && col >= 0 && col < d.W && c0 + ch < d.C;
      const T* src = ok ? src_row + static_cast<long long>(col) * d.C + ch
                        : base;
      if constexpr (VECIO) {
        cp_async16(dst + k * EU, src, ok);
      } else {
        dst[k] = ok ? *src : from_f32<T>(0.f);
      }
    }
  }
}

// Output row r of a column: top and mid hold dy rows r - 1 and r (columns
// j - 1 .. j + 1), bot is loaded with row r + 1. dx[p] = sum_t w[t] *
// dy[p - off_t] in tap order, each product and sum rounded apart; dw[t] +=
// x[p] * dy[p - off_t].
template <typename T, bool VECIO>
__device__ __forceinline__ void dx_row(
    const T* tdy, const T* tx, T* __restrict__ out, int r, int ld_row,
    int ld_x, long long ld_out, int c, const float (&wr)[9][kCV],
    float (&sw)[9][kCV], const float (&top)[3][kCV],
    const float (&mid)[3][kCV], float (&bot)[3][kCV], const BwdGeom& d) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    load<T, kCV>(tdy + (r + 2) * ld_row + e * d.chunk, bot[e]);
  }
  float xv[kCV], acc[kCV];
  load<T, kCV>(tx + r * ld_x, xv);
#pragma unroll
  for (int k = 0; k < kCV; ++k) acc[k] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      // dy[p - off_t]: row r - oy (bot, mid, top), column j - ox
      const float v = t < 3   ? bot[2 - t % 3][k]
                      : t < 6 ? mid[2 - t % 3][k]
                              : top[2 - t % 3][k];
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v, wr[t][k]));
      sw[t][k] = fmaf(xv[k], v, sw[t][k]);
    }
  }
  T* o = out + r * ld_out;
  if constexpr (VECIO) {  // C is a multiple of the copy width
    if (c < d.C) store<T, kCV>(o, acc);
  } else {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      if (c + k < d.C) o[k] = from_f32<T>(acc[k]);
    }
  }
}

// dx of stage `st` and this thread's dw sums, from the tiles in `buf`. Item
// (band s, column j, group grp) walks the band's rows down column j.
template <typename T, bool VECIO>
__device__ void compute_stage(const T* buf, int st, int grp, int c,
                              const float (&wr)[9][kCV], float (&sw)[9][kCV],
                              T* __restrict__ dx, const BwdGeom& d) {
  const int ld_row = (d.W + 2) * d.chunk;  // one row of a dy tile
  const int items = d.bands * d.W << d.gs;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int pix = it >> d.gs;
    const int s = pix / d.W, j = pix - s * d.W;
    const int sb = st * d.bands + s;
    if (sb >= d.nsub) break;
    const int b = sb / d.nb;
    const int row0 = (sb - b * d.nb) * d.rows;
    const int nr = min(d.rows, d.H - row0);
    // tile row 0, tile column j: dy at (row0 - 1, j - 1)
    const T* tdy = buf + s * d.tile_dy + j * d.chunk + grp * kCV;
    const T* tx = buf + d.bands * d.tile_dy + s * d.tile_x + j * d.chunk +
                  grp * kCV;
    T* out = dx + ((static_cast<long long>(b) * d.H + row0) * d.W + j) * d.C +
             c;
    // three rows of the 3x3 dy window, rotated as the column is walked
    float w0[3][kCV], w1[3][kCV], w2[3][kCV];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      load<T, kCV>(tdy + e * d.chunk, w0[e]);
      load<T, kCV>(tdy + ld_row + e * d.chunk, w1[e]);
    }
    const int ld_x = d.W * d.chunk;
    const long long ld_out = static_cast<long long>(d.W) * d.C;
    int r = 0;
    for (; r + 3 <= nr; r += 3) {
      dx_row<T, VECIO>(tdy, tx, out, r, ld_row, ld_x, ld_out, c, wr, sw, w0,
                       w1, w2, d);
      dx_row<T, VECIO>(tdy, tx, out, r + 1, ld_row, ld_x, ld_out, c, wr, sw,
                       w1, w2, w0, d);
      dx_row<T, VECIO>(tdy, tx, out, r + 2, ld_row, ld_x, ld_out, c, wr, sw,
                       w2, w0, w1, d);
    }
    if (r < nr) {
      dx_row<T, VECIO>(tdy, tx, out, r, ld_row, ld_x, ld_out, c, wr, sw, w0,
                       w1, w2, d);
    }
    if (r + 1 < nr) {
      dx_row<T, VECIO>(tdy, tx, out, r + 1, ld_row, ld_x, ld_out, c, wr, sw,
                       w1, w2, w0, d);
    }
  }
}

// Block (chunk, part): channels [chunk * d.chunk, ...), stages [st0, st1).
// Writes dx there and the block's dw partial part_ws[part][t][c] (dw itself
// when d.parts is 1).
template <typename T, bool VECIO>
__global__ void __launch_bounds__(kThreads, 2)
dwconv_bwd(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ dw,
           float* __restrict__ part_ws, BwdGeom d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int stage_elems = d.bands * (d.tile_dy + d.tile_x);
  const int c0 = blockIdx.x * d.chunk;
  const int grp = threadIdx.x % d.groups;
  const int c = c0 + grp * kCV;
  const int st0 = static_cast<int>(1ll * d.stages * blockIdx.y / d.parts);
  const int st1 =
      static_cast<int>(1ll * d.stages * (blockIdx.y + 1) / d.parts);
  float wr[9][kCV], sw[9][kCV];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      wr[t][k] = c + k < d.C ? to_f32(w[t * d.C + c + k]) : 0.f;
      sw[t][k] = 0.f;
    }
  }
  if (st0 < st1) load_stage<T, VECIO>(x, g, tiles, st0, c0, d);
  cp_async_commit();
  for (int st = st0; st < st1; ++st) {
    const int buf = (st - st0) & 1;
    if (st + 1 < st1) {
      load_stage<T, VECIO>(x, g, tiles + (buf ^ 1) * stage_elems, st + 1, c0,
                           d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute_stage<T, VECIO>(tiles + buf * stage_elems, st, grp, c, wr, sw, dx,
                            d);
    __syncthreads();
  }
  // the block's dw: the threads of each channel group summed in order
  float* red = reinterpret_cast<float*>(smem);  // [lanes][9][chunk]
  const int lanes = kThreads / d.groups, lane = threadIdx.x / d.groups;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      red[(lane * 9 + t) * d.chunk + grp * kCV + k] = sw[t][k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * d.chunk; i += blockDim.x) {
    const int t = i / d.chunk, cc = i % d.chunk;
    if (c0 + cc >= d.C) continue;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[(l * 9 + t) * d.chunk + cc];
    if (d.parts == 1) {
      dw[t * d.C + c0 + cc] = from_f32<T>(s);
    } else {
      part_ws[(static_cast<long long>(blockIdx.y) * 9 + t) * d.C + c0 + cc] =
          s;
    }
  }
}

bool dims_ok(const Dims& d) {
  return d.B >= 1 && d.H >= 1 && d.W >= 1 && d.C >= 1;
}

// The vector widths each direction takes for element type T.
template <typename T>
constexpr int fwd_vec() { return 16 / sizeof(T); }

template <typename T, int VEC>
cudaError_t launch_fwd(const void* x, const void* w, void* y, const Dims& d,
                       cudaStream_t stream) {
  const long long n = d.pixels() * (d.C / VEC);
  dwconv_fwd<T, VEC><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* y, const Dims& d,
                int vec, cudaStream_t stream) {
  if (vec == 1) return launch_fwd<T, 1>(x, w, y, d, stream);
  if (vec == fwd_vec<T>()) return launch_fwd<T, fwd_vec<T>()>(x, w, y, d,
                                                              stream);
  return cudaErrorInvalidValue;
}

// Shared memory of one block: two stage buffers, at least the block's dw
// sums [kThreads, 9, kCV] fp32 (ops/dwconv.py:bwd_smem_bytes).
template <typename T>
long long bwd_smem(const BwdGeom& d) {
  const long long tiles = 2ll * d.bands *
                          ((d.rows + 2ll) * (d.W + 2) + 1ll * d.rows * d.W) *
                          d.chunk * sizeof(T);
  const long long red = 1ll * kThreads * 9 * kCV * sizeof(float);
  return tiles > red ? tiles : red;
}

// The plan's geometry, or false where the kernel cannot take it.
template <typename T>
bool bwd_geom(const Dims& dims, int rows, int chunk, int bands, int parts,
              int smem, bool vecio, BwdGeom* out) {
  constexpr int EU = 16 / sizeof(T);
  if (!dims_ok(dims) || rows < 1 || rows > dims.H || chunk < kCV ||
      chunk % kCV != 0 || bands < 1 || parts < 1 || parts > 65535) {
    return false;
  }
  const int groups = chunk / kCV;
  if (groups > kThreads || kThreads % groups != 0) return false;
  if (vecio && (dims.C % EU != 0 || chunk % EU != 0)) return false;
  BwdGeom d{dims.B, dims.H, dims.W, dims.C, rows, chunk, bands, parts,
            groups, ilog2(groups), ilog2(chunk)};
  d.nb = (dims.H + rows - 1) / rows;
  if (1ll * dims.B * d.nb >= (1ll << 31)) return false;  // bands are ints
  d.nsub = dims.B * d.nb;
  d.stages = (d.nsub + bands - 1) / bands;
  const long long need = bwd_smem<T>(d);
  if (need > kMaxSmem || need != smem || parts > d.stages) return false;
  d.tile_dy = (rows + 2) * (dims.W + 2) * chunk;
  d.tile_x = rows * dims.W * chunk;
  *out = d;
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T, bool VECIO>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* dw, float* ws, const BwdGeom& d, int smem,
                       cudaStream_t stream) {
  cudaError_t err = set_smem(dwconv_bwd<T, VECIO>, smem);
  if (err != cudaSuccess) return err;
  dwconv_bwd<T, VECIO><<<dim3((d.C + d.chunk - 1) / d.chunk, d.parts),
                         kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<T*>(dw), ws,
      d);
  if ((err = cudaGetLastError())) return err;
  if (d.parts == 1) return cudaSuccess;
  return reduce<T>(ws, d.parts, 9ll * d.C, 9 * d.C, dw, stream);
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* g, void* dx,
                void* dw, float* ws, const Dims& dims, int rows, int chunk,
                int bands, int parts, int smem, bool vecio,
                cudaStream_t stream) {
  BwdGeom d;
  if (!bwd_geom<T>(dims, rows, chunk, bands, parts, smem, vecio, &d) ||
      (vecio && !(aligned16(x) && aligned16(g) && aligned16(dx))) ||
      (parts > 1 && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (vecio) return launch_bwd<T, true>(x, w, g, dx, dw, ws, d, smem, stream);
  return launch_bwd<T, false>(x, w, g, dx, dw, ws, d, smem, stream);
}

}  // namespace

// x, y [B, H, W, C], w [9, C]: contiguous, of type `dtype`. vec: channels
// per thread, 1 or 16 bytes' worth (C and the pointers must allow it).
extern "C" int ogvt_dwconv3x3(const void* x, const void* w, void* y, int B,
                              int H, int W, int C, int vec, int dtype,
                              void* stream) {
  const Dims d{B, H, W, C};
  if (!dims_ok(d) || vec < 1 || C % vec != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return fwd<float>(x, w, y, d, vec, s);
    case kBFloat16:
      return fwd<__nv_bfloat16>(x, w, y, d, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, dy, dx [B, H, W, C], w, dw [9, C]: contiguous, of type `dtype`. rows,
// chunk, bands, parts, smem: ops/dwconv.py:dwconv3x3_backward_plan (checked
// here). vecio: 16-byte copies (C a multiple of 16 bytes' worth, x, dy and
// dx 16-byte aligned), else one element at a time. ws: parts * 9 * C fp32
// floats when parts > 1.
extern "C" int ogvt_dwconv3x3_bwd(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* ws, int B, int H, int W, int C,
                                  int rows, int chunk, int bands, int parts,
                                  int smem, int vecio, int dtype,
                                  void* stream) {
  const Dims d{B, H, W, C};
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return bwd<float>(x, w, dy, dx, dw, f, d, rows, chunk, bands, parts,
                        smem, vecio != 0, s);
    case kBFloat16:
      return bwd<__nv_bfloat16>(x, w, dy, dx, dw, f, d, rows, chunk, bands,
                                parts, smem, vecio != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}
