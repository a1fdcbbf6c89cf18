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
// read as fp32; the 9 taps summed in fp32 in order from 0, each product and
// sum rounded apart (__fmul_rn / __fadd_rn, as the plain version's separate
// multiply and add, so y and dx equal it bit for bit); y and dx cast once;
// dw an fp32 sum over every pixel, cast once to w's type.
//
// What bounds it on the H100: 18 flop per element forward (36 backward)
// against 4 bytes moved in bf16 (x read, y written; backward 6: x and dy
// read, dx written): 4.5-6 flop per byte, below the fp32 pipe's balance
// (67 TFLOP/s over 3.35 TB/s, ~20), so both are bound by bytes. Least time
// at Model B's stage 0 (32x32x256, bf16): forward at B = 64 67 MB, 20 us;
// backward at B = 128 201 MB, 60 us; at the Tiny-ImageNet stage 0
// (64x64x256) backward 805 MB, 240 us. Issue comes close behind: the
// rounding points forbid FMA, so a forward element costs 18 fp32
// instructions plus its share of shared-memory reads, conversions and
// stores. And how a block reads memory matters: a block that reads a
// narrow piece of each pixel (its chunk of channels, strided by the pixel)
// reads device memory well below its rate, the less so the wider the piece
// (32, 64, 128 bytes and up, in a sweep of the forward's plans on an
// H100), so the forward's plan takes wide chunks and, to keep tall bands
// within shared memory, cuts the width into tiles.
//
// Both read the natural NHWC layout (the TPU kernels' transposed [C*H, B*W]
// one would cost two transposes a call).
//
// One kernel template serves both directions (BWD), cut by a plan made in
// Python (ops/dwconv.py: dwconv3x3_forward_plan, dwconv3x3_backward_plan),
// which this file checks:
// - Block (chunk, part) owns `chunk` channels and the part-th run of
//   stages. A stage is `bands` bands; a band is `rows` output rows by `tw`
//   columns of one image (the backward's span the width; at small maps a
//   band is a whole image). For each stage the block copies the halo tile
//   [rows + 2, tw + 2, chunk] (of x forward, of dy backward) and, backward
//   only, the tile of x [rows, tw, chunk] into shared memory with 16-byte
//   cp.async, zero-filled (src-size 0) outside the image, in two buffers:
//   stage k + 1 loads while stage k computes (deeper rings measured no
//   faster). Every element comes from device memory once; only the halo
//   rows and columns of a band that does not span the image are read
//   twice, mostly from L2. x needs no halo backward: dw is summed as x[q] *
//   dy[q - off_t].
// - A thread owns kCV channels for the whole launch (their 9 weights, and
//   backward their 9 dw sums, stay in registers) and one column of a band
//   at a time, down which it slides a 3x3 window of the halo tile in
//   registers: one new row of 3 reads from shared memory per output pixel
//   (backward also x at the pixel itself), its pointers stepped a row at a
//   time and its items (band, column) stepped without a division.
// - y and dx: the taps in the plain version's order, each product and sum
//   rounded apart, one cast; a warp's stores cover contiguous channels of
//   neighbouring pixels.
// - dw (backward): each thread sums its pixels in fp32, the block sums its
//   threads in a fixed order into one [9, chunk] partial. The plan sets the
//   blocks per chunk so that the partials' bytes (written and read) stay
//   within 10% of x, dy and dx; a second launch sums them in block order
//   (partials.cuh), and with one block per chunk the block writes dw
//   itself. No float atomics: two calls give bitwise-equal dw. The forward
//   has no partials: its plan fills a wave of two or three blocks an SM.
// - Where C or a pointer does not allow 16-byte copies, the same kernel
//   copies and stores one element at a time (VECIO false).
// - Registers (ptxas -v, sm_90a; one-element / 16-byte copies): the
//   backward thread keeps 9*kCV weights, 9*kCV sums and a 9*kCV window,
//   123 / 104 registers in bf16 and 118 / 112 in fp32, no spills, under
//   __launch_bounds__(256, 2): two blocks an SM, so its plan keeps a
//   launch to one wave of 264 blocks. The forward keeps weights and window
//   only: 75 / 80 in bf16, 70 / 77 in fp32, under __launch_bounds__(256,
//   3).
#include <type_traits>

#include "common.cuh"
#include "partials.cuh"

using namespace ogvt;

namespace {

constexpr int kThreads = 256;
constexpr int kCV = 2;             // channels per thread
constexpr int kMaxSmem = 232448;   // what one block may ask for

struct Dims {
  int B, H, W, C;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && VEC == 2) {
    // a bf16 is the upper half of its fp32: two from one word, one
    // instruction each
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(r.e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  Pack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = r;
}

// A launch's cut (ops/dwconv.py: dwconv3x3_forward_plan and
// dwconv3x3_backward_plan).
struct Geom {
  int B, H, W, C;
  int rows, tw, chunk, bands, parts;
  int groups;  // chunk / kCV, a power of two: thread t owns group t % groups
  int gs, cs;  // log2(groups), log2(chunk)
  int nbr;     // row bands per image: ceil(H / rows)
  int ntw;     // column tiles per row band: ceil(W / tw)
  int nb;      // bands per image: nbr * ntw, the column tile fastest
  int nsub;    // bands in all: B * nb
  int stages;  // ceil(nsub / bands)
  int tile_h;  // elements of one band's halo tile [rows + 2, tw + 2, chunk]
  int tile_x;  // and of its x tile [rows, tw, chunk] (backward; forward 0)
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

// Copy stage `st` of channels [c0, c0 + chunk) into `buf`: the bands' halo
// tiles of `h` (x forward, dy backward), then, where the geometry has them,
// their x tiles, one tile row per warp at a time. Zeros outside the image,
// past C and past the last band. VECIO: 16-byte cp.async; else one element
// at a time. Band sb is image sb / nb, row band bi / ntw and column tile
// bi % ntw of it, bi = sb % nb.
template <typename T, bool VECIO>
__device__ void load_stage(const T* __restrict__ x, const T* __restrict__ h,
                           T* buf, int st, int c0, const Geom& d) {
  constexpr int EU = VECIO ? 16 / sizeof(T) : 1;  // elements per copy
  const int qs = d.cs - ilog2(EU);                // log2(copies per pixel)
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int h_lines = d.bands * (d.rows + 2);
  const int lines = h_lines + (d.tile_x ? d.bands * d.rows : 0);
  for (int line = warp; line < lines; line += nwarps) {
    const bool isx = line >= h_lines;
    const int l = isx ? line - h_lines : line;
    const int trows = isx ? d.rows : d.rows + 2;
    const int halo = isx ? 0 : 1;
    const int s = l / trows;
    const int sb = st * d.bands + s;
    const int b = sb / d.nb, bi = sb - b * d.nb;
    const int rb = bi / d.ntw, col0 = (bi - rb * d.ntw) * d.tw - halo;
    const int row = rb * d.rows + (l - s * trows) - halo;
    const bool row_ok = sb < d.nsub && row >= 0 && row < d.H;
    const int cols = isx ? d.tw : d.tw + 2;
    const T* base = isx ? x : h;
    const T* src_row =
        base + (static_cast<long long>(b) * d.H + row) * d.W * d.C + c0;
    T* dst = buf + (isx ? d.bands * d.tile_h + l * d.tw * d.chunk
                        : l * (d.tw + 2) * d.chunk);
    for (int k = threadIdx.x % 32; k < (cols << qs); k += 32) {
      const int col = col0 + (k >> qs), ch = (k & ((1 << qs) - 1)) * EU;
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

// One output row of a column: top and mid hold the halo tile's rows r and
// r + 1 (image rows r - 1 and r, columns j - 1 .. j + 1), bot is loaded
// from hb, the tile's row r + 2. Forward: o[] = y[p] = sum_t w[t] *
// x[p + off_t]; backward: o[] = dx[p] = sum_t w[t] * dy[p - off_t], and
// dw[t] += x[p] * dy[p - off_t] with x[p] at xr. The taps in order, each
// product and sum rounded apart.
template <typename T, bool VECIO, bool BWD>
__device__ __forceinline__ void tap_row(
    const T* hb, const T* xr, T* __restrict__ o, int c, int chunk, int C,
    const float (&wr)[9][kCV], float (&sw)[9][kCV],
    const float (&top)[3][kCV], const float (&mid)[3][kCV],
    float (&bot)[3][kCV]) {
#pragma unroll
  for (int e = 0; e < 3; ++e) load<T, kCV>(hb + e * chunk, bot[e]);
  float xv[kCV], acc[kCV];
  if constexpr (BWD) load<T, kCV>(xr, xv);
#pragma unroll
  for (int k = 0; k < kCV; ++k) acc[k] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      float v;
      if constexpr (BWD) {  // dy[p - off_t]: row r - oy, column j - ox
        v = t < 3 ? bot[2 - t % 3][k] : t < 6 ? mid[2 - t % 3][k]
                                              : top[2 - t % 3][k];
      } else {  // x[p + off_t]: row r + oy, column j + ox
        v = t < 3 ? top[t % 3][k] : t < 6 ? mid[t % 3][k] : bot[t % 3][k];
      }
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v, wr[t][k]));
      if constexpr (BWD) sw[t][k] = fmaf(xv[k], v, sw[t][k]);
    }
  }
  if constexpr (VECIO) {  // the thread's channels lie inside C
    store<T, kCV>(o, acc);
  } else {
#pragma unroll
    for (int k = 0; k < kCV; ++k) {
      if (c + k < C) o[k] = from_f32<T>(acc[k]);
    }
  }
}

// y (dx) of stage `st`, and backward this thread's dw sums, from the tiles
// in `buf`. Item (band s, column j, group grp) walks the band's rows down
// column j, its tile and output pointers stepped a row at a time.
template <typename T, bool VECIO, bool BWD>
__device__ void compute_stage(const T* buf, int st, int grp, int c,
                              const float (&wr)[9][kCV], float (&sw)[9][kCV],
                              T* __restrict__ out, const Geom& d) {
  // with 16-byte copies C is a multiple of kCV: a thread past C has no
  // output (and backward no dw) in any item
  if (VECIO && c >= d.C) return;
  const int ld_row = (d.tw + 2) * d.chunk;  // one row of a halo tile
  const int ld_x = d.tw * d.chunk;
  const long long ld_out = static_cast<long long>(d.W) * d.C;
  // the thread's items in order, (band s, tile column j) stepped without a
  // division: column j + step, wrapping into the next band (image b, row
  // band rb, column tile cb)
  const int step = blockDim.x >> d.gs;
  int s = (threadIdx.x >> d.gs) / d.tw, j = (threadIdx.x >> d.gs) - s * d.tw;
  int sb = st * d.bands + s;
  int b = sb / d.nb, rb = (sb - b * d.nb) / d.ntw;
  int cb = sb - b * d.nb - rb * d.ntw;
  for (; s < d.bands && sb < d.nsub;) {
    const int row0 = rb * d.rows, col = cb * d.tw + j;
    const int nr = col < d.W ? min(d.rows, d.H - row0) : 0;
    // tile row 0, tile column j: the halo source at (row0 - 1, col - 1)
    const T* th = buf + s * d.tile_h + j * d.chunk + grp * kCV;
    const T* xr = buf + d.bands * d.tile_h + s * d.tile_x + j * d.chunk +
                  grp * kCV;
    T* o = out + ((static_cast<long long>(b) * d.H + row0) * d.W + col) *
                     d.C + c;
    // three rows of the 3x3 window, rotated as the column is walked
    float w0[3][kCV], w1[3][kCV], w2[3][kCV];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      load<T, kCV>(th + e * d.chunk, w0[e]);
      load<T, kCV>(th + ld_row + e * d.chunk, w1[e]);
    }
    const T* hb = th + 2 * ld_row;
    int r = 0;
    for (; r + 3 <= nr; r += 3) {
      tap_row<T, VECIO, BWD>(hb, xr, o, c, d.chunk, d.C, wr, sw, w0, w1, w2);
      tap_row<T, VECIO, BWD>(hb + ld_row, xr + ld_x, o + ld_out, c, d.chunk,
                             d.C, wr, sw, w1, w2, w0);
      tap_row<T, VECIO, BWD>(hb + 2 * ld_row, xr + 2 * ld_x, o + 2 * ld_out,
                             c, d.chunk, d.C, wr, sw, w2, w0, w1);
      hb += 3 * ld_row;
      xr += 3 * ld_x;
      o += 3 * ld_out;
    }
    if (r < nr) {
      tap_row<T, VECIO, BWD>(hb, xr, o, c, d.chunk, d.C, wr, sw, w0, w1, w2);
    }
    if (r + 1 < nr) {
      tap_row<T, VECIO, BWD>(hb + ld_row, xr + ld_x, o + ld_out, c, d.chunk,
                             d.C, wr, sw, w1, w2, w0);
    }
    for (j += step; j >= d.tw; j -= d.tw) {
      ++s;
      ++sb;
      if (++cb == d.ntw) {
        cb = 0;
        if (++rb == d.nbr) {
          rb = 0;
          ++b;
        }
      }
    }
  }
}

// The block's dw from its threads' sums sw, the threads of each channel
// group summed in order through `red` [kThreads / groups][9][chunk] fp32:
// dw itself when d.parts is 1, else the block's partial part_ws[part][t][c].
template <typename T>
__device__ void block_dw(const float (&sw)[9][kCV], float* red, int grp,
                         int c0, T* __restrict__ dw,
                         float* __restrict__ part_ws, const Geom& d) {
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

// Block (chunk, part): channels [chunk * d.chunk, ...), stages [st0, st1).
// Forward: y from x (g, dw and part_ws unused). Backward: dx from dy = g,
// and the block's dw partial part_ws[part][t][c] (dw itself when d.parts is
// 1).
template <typename T, bool VECIO, bool BWD>
__global__ void __launch_bounds__(kThreads, BWD ? 2 : 3)
dwconv(const T* __restrict__ x, const T* __restrict__ w,
       const T* __restrict__ g, T* __restrict__ out, T* __restrict__ dw,
       float* __restrict__ part_ws, Geom d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const T* h = BWD ? g : x;  // the halo tiles' source
  const int stage_elems = d.bands * (d.tile_h + d.tile_x);
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
  if (st0 < st1) load_stage<T, VECIO>(x, h, tiles, st0, c0, d);
  cp_async_commit();
  for (int st = st0; st < st1; ++st) {
    const int buf = (st - st0) & 1;
    if (st + 1 < st1) {
      load_stage<T, VECIO>(x, h, tiles + (buf ^ 1) * stage_elems, st + 1, c0,
                           d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute_stage<T, VECIO, BWD>(tiles + buf * stage_elems, st, grp, c, wr,
                                 sw, out, d);
    __syncthreads();
  }
  if constexpr (BWD) {
    block_dw(sw, reinterpret_cast<float*>(smem), grp, c0, dw, part_ws, d);
  }
}

// Shared memory of one block: two stage buffers; backward at least the
// block's dw sums [kThreads, 9, kCV] fp32 (ops/dwconv.py: fwd_smem_bytes,
// bwd_smem_bytes).
template <typename T>
long long smem_bytes(const Geom& d, bool bwd) {
  const long long tile = (d.rows + 2ll) * (d.tw + 2) +
                         (bwd ? 1ll * d.rows * d.tw : 0ll);
  const long long tiles = 2ll * d.bands * tile * d.chunk * sizeof(T);
  const long long red = bwd ? 1ll * kThreads * 9 * kCV * sizeof(float) : 0;
  return tiles > red ? tiles : red;
}

// The plan's geometry, or false where the kernel cannot take it.
template <typename T>
bool make_geom(const Dims& dims, int rows, int tw, int chunk, int bands,
               int parts, int smem, bool vecio, bool bwd, Geom* out) {
  constexpr int EU = 16 / sizeof(T);
  if (dims.B < 1 || dims.H < 1 || dims.W < 1 || dims.C < 1 || rows < 1 ||
      rows > dims.H || tw < 1 || tw > dims.W || (bwd && tw != dims.W) ||
      chunk < kCV || chunk % kCV != 0 || bands < 1 || parts < 1 ||
      parts > 65535) {
    return false;
  }
  const int groups = chunk / kCV;
  if (groups > kThreads || kThreads % groups != 0) return false;
  if (vecio && (dims.C % EU != 0 || chunk % EU != 0)) return false;
  Geom d{dims.B, dims.H, dims.W, dims.C, rows, tw, chunk, bands, parts,
         groups, ilog2(groups), ilog2(chunk)};
  d.nbr = (dims.H + rows - 1) / rows;
  d.ntw = (dims.W + tw - 1) / tw;
  if (1ll * dims.B * d.nbr * d.ntw >= (1ll << 31)) return false;  // ints
  d.nb = d.nbr * d.ntw;
  d.nsub = dims.B * d.nb;
  d.stages = (d.nsub + bands - 1) / bands;
  const long long need = smem_bytes<T>(d, bwd);
  if (need > kMaxSmem || need != smem || parts > d.stages) return false;
  d.tile_h = (rows + 2) * (tw + 2) * chunk;
  d.tile_x = bwd ? rows * tw * chunk : 0;
  *out = d;
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T, bool VECIO, bool BWD>
cudaError_t launch(const void* x, const void* w, const void* g, void* out,
                   void* dw, float* ws, const Geom& d, int smem,
                   cudaStream_t stream) {
  auto kernel = dwconv<T, VECIO, BWD>;
  cudaError_t err = set_smem(kernel, smem);
  // the forward's blocks share an SM three at a time: ask for all of its
  // shared memory
  if (!err && !BWD) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  kernel<<<dim3((d.C + d.chunk - 1) / d.chunk, d.parts), kThreads, smem,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                     static_cast<const T*>(g), static_cast<T*>(out),
                     static_cast<T*>(dw), ws, d);
  if ((err = cudaGetLastError())) return err;
  if (!BWD || d.parts == 1) return cudaSuccess;
  return reduce<T>(ws, d.parts, 9ll * d.C, 9 * d.C, dw, stream);
}

// Forward when g is null: y = out from x. Backward: dx = out and dw from x
// and dy = g.
template <typename T>
cudaError_t run(const void* x, const void* w, const void* g, void* out,
                void* dw, float* ws, const Dims& dims, int rows, int tw,
                int chunk, int bands, int parts, int smem, bool vecio,
                cudaStream_t stream) {
  const bool bwd = g != nullptr;
  Geom d;
  if (!make_geom<T>(dims, rows, tw, chunk, bands, parts, smem, vecio, bwd,
                    &d) ||
      (vecio && !(aligned16(x) && aligned16(out) && (!bwd || aligned16(g)))) ||
      (bwd && parts > 1 && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (bwd) {
    return vecio ? launch<T, true, true>(x, w, g, out, dw, ws, d, smem, stream)
                 : launch<T, false, true>(x, w, g, out, dw, ws, d, smem,
                                          stream);
  }
  return vecio ? launch<T, true, false>(x, w, g, out, dw, ws, d, smem, stream)
               : launch<T, false, false>(x, w, g, out, dw, ws, d, smem,
                                         stream);
}

cudaError_t dispatch(const void* x, const void* w, const void* g, void* out,
                     void* dw, void* ws, int B, int H, int W, int C, int rows,
                     int tw, int chunk, int bands, int parts, int smem,
                     int vecio, int dtype, void* stream) {
  const Dims d{B, H, W, C};
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return run<float>(x, w, g, out, dw, f, d, rows, tw, chunk, bands,
                        parts, smem, vecio != 0, s);
    case kBFloat16:
      return run<__nv_bfloat16>(x, w, g, out, dw, f, d, rows, tw, chunk,
                                bands, parts, smem, vecio != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y [B, H, W, C], w [9, C]: contiguous, of type `dtype`. rows, tw,
// chunk, bands, parts, smem: ops/dwconv.py:dwconv3x3_forward_plan (checked
// here). vecio: 16-byte copies (C a multiple of 16 bytes' worth, x and y
// 16-byte aligned), else one element at a time.
extern "C" int ogvt_dwconv3x3(const void* x, const void* w, void* y, int B,
                              int H, int W, int C, int rows, int tw,
                              int chunk, int bands, int parts, int smem,
                              int vecio, int dtype, void* stream) {
  return dispatch(x, w, nullptr, y, nullptr, nullptr, B, H, W, C, rows, tw,
                  chunk, bands, parts, smem, vecio, dtype, stream);
}

// x, dy, dx [B, H, W, C], w, dw [9, C]: contiguous, of type `dtype`. rows,
// chunk, bands, parts, smem: ops/dwconv.py:dwconv3x3_backward_plan (checked
// here; its bands span the width). vecio: 16-byte copies (C a multiple of
// 16 bytes' worth, x, dy and dx 16-byte aligned), else one element at a
// time. ws: parts * 9 * C fp32 floats when parts > 1.
extern "C" int ogvt_dwconv3x3_bwd(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* ws, int B, int H, int W, int C,
                                  int rows, int chunk, int bands, int parts,
                                  int smem, int vecio, int dtype,
                                  void* stream) {
  if (dy == nullptr) return cudaErrorInvalidValue;
  return dispatch(x, w, dy, dx, dw, ws, B, H, W, C, rows, W, chunk, bands,
                  parts, smem, vecio, dtype, stream);
}
