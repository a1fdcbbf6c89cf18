// Forward of the fused pre-LN grid-attention branch
// y = proj(MHSA(qkv(LN(x)))) in bf16, with every product on mma.sync
// tensor-core tiles, for grids of 64 tokens on tokens or on an NHWC map.
//
// Replaces the TPU kernels outgridvit_tpu/ops/attn_branch_pallas.py:
// attn_branch_pallas (#5) and outgridvit_tpu/ops/experimental/
// attn_branch_nhwc_pallas.py:attn_branch_nhwc_pallas (#12), forward half
// (`_fwd_kernel`, `_rows_fwd`), for the bf16 launches whose shape the
// kernel is instantiated at (attn_branch_mma_layout.h:takes; the shipped
// N = 64, C = 64 / hd 32 and C = 80 / hd 40). ops/attn_branch.py routes
// them here (forward_entry); fp32 and other shapes keep csrc/attn_branch.cu.
// The rounding points are that kernel's (csrc/attn_branch.cu's docstring):
//   xn = round(LN(x)), fp32 statistics, the fast variance clamped at 0;
//   qkv = round(xn.Wqkv + bqkv); per head S = q.k^T summed in fp32, then
//   scaled; a = softmax(S) in fp32, the max subtracted, divided by the sum
//   (IEEE division); out = round(round(a).v); y = round(out.Wp + bp).
// Every product's operands are bf16 values at those points, so one bf16
// mma.sync forms each product exactly and sums it in fp32: only the order
// of the fp32 sums differs from the plain version.
//
// What bounds it on the H100: per grid 2*N*C*(4C + 2N) flops (3.1 MFLOP at
// N = C = 64) against 4*N*C bytes of x and y (16 KB): ~190 flop/byte, under
// the tensor cores' ridge (~295), so the bytes set the bound: 20 us a
// launch of 4,096 grids (Tiny-ImageNet's stage 0 at batch 64, 2 launches
// a forward). Next, the softmax: an exp and a division per logit, 8,192 a
// grid at 2 heads.
//
// What the design does about it. attn_branch_fwd_mma: blocks of 8 warps,
// two an SM (77 / 106 KB of shared memory, 128 registers a thread), each
// walking a contiguous run of grids (about one wave). Wqkv and Wp stay in
// shared memory in their own layouts, read by ldmatrix.trans. One x tile:
// the next grid's x is copied into it by 16-byte cp.async as soon as this
// grid's qkv is formed, and lands while this grid's attention and
// projection run (Geom::token gives a token's row, so #5 and #12 share the
// kernel). Warp (rt, h) takes the 16 rows of row tile rt:
//   - LN of rows 8w.. into the xn tile, then qkv's half h of the columns
//     on mma, rounded with bqkv into the qkv tile (attn_branch_mma.cuh's
//     ln_rows and qkv_rows, the backward's recompute: the same xn and qkv);
//   - head h: S = q.k^T in 8 n8 accumulators (an m16n8k8 step for the k
//     tail of a head of 40), the fp32 softmax in registers
//     (grid_mhsa_packed_mma.cuh), round(a) packed straight into the A
//     fragments of round(a).v, out rounded into the xn tile;
//   - y's half h of the columns: y = out.Wp needs all C columns of out for
//     the warp's rows, but the warps hold them head by head. out goes
//     through the xn tile, and after one barrier each warp of a row tile
//     takes C/2 columns of y over all C of k, in k order as the plain
//     product, as the backward takes dout. A split over k (each warp its
//     head's k range, all C columns) would still add the two halves through
//     shared memory, as fp32 partials (twice the bytes), and would change
//     the order of y's sums.
//   - y rounded with bp into the qkv tile (free once every warp's attention
//     is done), then out by 16-byte stores.
// No float atomics and no sums across grids: two calls are bitwise equal,
// and #12's y is #5's on the partitioned tokens, bit for bit. Staged rows
// are an odd number of 16-byte units apart (row_bytes), so the 8 rows one
// ldmatrix reads fall in 8 distinct bank groups. The launch plan (blocks,
// grids a block, shared bytes) is ops/attn_branch.py:
// attn_branch_forward_plan, made from the layout query of
// attn_branch_mma_layout.cpp; the layout itself is attn_branch_mma_layout.h,
// and the entry points refuse any plan it does not match.
#include "attn_branch_mma.cuh"
#include "common.cuh"
#include "grid_mhsa_packed_mma.cuh"

using namespace ogvt;
using namespace ogvt::attn_mma;

namespace {

// CT = C / 16, NT = hd / 8.
template <int CT, int NT>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
attn_branch_fwd_mma(const bf16* __restrict__ x, const float* __restrict__ ls,
                    const float* __restrict__ lb,
                    const bf16* __restrict__ wqkv,
                    const bf16* __restrict__ bqkv,
                    const bf16* __restrict__ wp, const bf16* __restrict__ bp,
                    bf16* __restrict__ y, Geom geo, int G, int grids,
                    float scale, float eps, int apply_ln) {
  constexpr int C = 16 * CT, C3 = 3 * C, HD = 8 * NT;
  constexpr int QT = 3 * CT;  // qkv n8 tiles a warp: half of 3C
  static_assert(C == 2 * HD, "a warp takes one head: the built shapes' two");
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdGeom g = fwd_geom(C);
  const unsigned base = smem_addr(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = warp & 3, h = warp >> 2;  // row tile; head and column half
  const int r0 = 16 * rt, cq = h * HD;     // cq: the head's first column
  unsigned char* t_x = smem + g.x;
  unsigned char* t_xn = smem + g.xn;
  unsigned char* t_qkv = smem + g.qkv;
  const unsigned s_x = base + g.x, s_xn = base + g.xn, s_qkv = base + g.qkv;

  const int w0 = blockIdx.x * grids, w1 = min(G, w0 + grids);
  stage_rows(base + g.wqkv, wqkv, C, C3, g.rowQ);
  stage_rows(base + g.wp, wp, C, C, g.rowC);
  if (w0 < w1) stage_grid(s_x, x, geo, w0, C, g.rowC);
  cp_async_commit();

  for (int w = w0; w < w1; ++w) {
    cp_async_wait<0>();
    __syncthreads();  // grid w's x staged; grid w - 1's y stored
    if (apply_ln) {
      ln_rows(t_x, t_xn, g.rowC, C, ls, lb, eps, nullptr, nullptr);
      __syncthreads();  // xn
    }
    qkv_rows<CT, QT>(t_qkv, g.rowQ,
                     rows_a(apply_ln ? s_xn : s_x, g.rowC, r0, lane),
                     base + g.wqkv, bqkv, r0, h * QT, lane);
    __syncthreads();  // qkv; x and xn are read no more
    if (w + 1 < w1) {
      stage_grid(s_x, x, geo, w + 1, C, g.rowC);
      cp_async_commit();
    }

    // head h of the warp's 16 query rows: S = q.k^T over the 64 keys in 8
    // n8 tiles, a = softmax in fp32, out = round(round(a).v) into the xn
    // tile
    {
      float s[8][4];
      zero(s);
      mma_xyt<NT, 8>(s, rows_a(s_qkv, g.rowQ, r0, lane) + cq * 2,
                     s_qkv + (C + cq) * 2, g.rowQ, lane);
      packed::softmax<8>(s, scale, kN, lane);
      float o[NT][4];
      zero(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned a[1][4] = {
            {pack(s[2 * kk][0], s[2 * kk][1]),
             pack(s[2 * kk][2], s[2 * kk][3]),
             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])}};
        mma_rows<NT, 1>(o, a, s_qkv, g.rowQ, 16 * kk, (2 * C + cq) / 8,
                        lane);
      }
      put(t_xn, g.rowC, o, 1.f, r0, cq, lane);
    }
    __syncthreads();  // out, every head of every row

    // y = round(out.Wp + bp): the warp's rows, columns half h, over all C
    // of out in k16 steps; into the qkv tile at the xn tile's row stride
    {
      float acc[CT][4];
      zero(acc);
      const unsigned xa = rows_a(s_xn, g.rowC, r0, lane);
#pragma unroll
      for (int kc = 0; kc < CT; ++kc) {
        unsigned a[1][4];
        ldsm_x4(xa + kc * 32, a[0]);
        mma_rows<CT, 1>(acc, a, base + g.wp, g.rowC, 16 * kc, h * CT, lane);
      }
      add_bias(acc, bp, h * (C / 2), lane);
      put(t_qkv, g.rowC, acc, 1.f, r0, h * (C / 2), lane);
    }
    __syncthreads();  // y
    for (int i = threadIdx.x; i < kN * (C / 8); i += kThreads) {
      const int r = i / (C / 8), u = i - r * (C / 8);
      *reinterpret_cast<uint4*>(y + geo.token(w, r, kN, C) + u * 8) =
          *reinterpret_cast<const uint4*>(t_qkv + r * g.rowC + u * 16);
    }
  }
  cp_async_wait<0>();
}

struct Args {
  const bf16 *x, *wqkv, *bqkv, *wp, *bp;
  const float *ls, *lb;
  bf16* y;
  Geom geo;
  int G, N, C, heads;
  float scale, eps;
  int apply_ln;
};

// Whether the plan is one the kernel takes for these shapes: the shapes it
// is instantiated at, the layout's shared bytes, blocks that cover the
// grids.
bool plan_ok(const Args& a, int blocks, int grids, int smem) {
  return a.G > 0 && fwd_fits(a.N, a.C, a.heads) &&
         smem == fwd_geom(a.C).bytes && covers(a.G, blocks, grids);
}

template <int CT, int NT>
cudaError_t launch(const Args& a, int blocks, int grids, int smem,
                   cudaStream_t s) {
  auto k = attn_branch_fwd_mma<CT, NT>;
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<blocks, kThreads, smem, s>>>(a.x, a.ls, a.lb, a.wqkv, a.bqkv, a.wp,
                                   a.bp, a.y, a.geo, a.G, grids, a.scale,
                                   a.eps, a.apply_ln);
  return cudaGetLastError();
}

int fwd(const Args& a, int dtype, int blocks, int grids, int smem,
        void* stream) {
  if (dtype != kBFloat16 || !plan_ok(a, blocks, grids, smem) ||
      !aligned16(a.x) || !aligned16(a.wqkv) || !aligned16(a.wp) ||
      !aligned16(a.y)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiations: takes() of the layout header
  if (a.C == 64) return launch<4, 4>(a, blocks, grids, smem, s);
  return launch<5, 5>(a, blocks, grids, smem, s);
}

Args make_args(const void* x, const void* ln_scale, const void* ln_bias,
               const void* wqkv, const void* bqkv, const void* wp,
               const void* bp, void* y, Geom geo, int G, int N, int C,
               int heads, float scale, float eps, int apply_ln) {
  return Args{static_cast<const bf16*>(x),
              static_cast<const bf16*>(wqkv),
              static_cast<const bf16*>(bqkv),
              static_cast<const bf16*>(wp),
              static_cast<const bf16*>(bp),
              static_cast<const float*>(ln_scale),
              static_cast<const float*>(ln_bias),
              static_cast<bf16*>(y), geo, G, N, C, heads, scale, eps,
              apply_ln};
}

}  // namespace

// x, y [G, N, C]; wqkv [C, 3C]; bqkv [3C]; wp [C, C]; bp [C]: contiguous
// bf16 (dtype must be 1); x, wqkv, wp and y 16-byte aligned. ln_scale,
// ln_bias [C]: float32. The plan is ops/attn_branch.py:
// attn_branch_forward_plan's: blocks, grids a block, shared bytes. Returns
// cudaErrorInvalidValue for a plan or shape it does not take.
extern "C" int ogvt_attn_branch_mma(const void* x, const void* ln_scale,
                                    const void* ln_bias, const void* wqkv,
                                    const void* bqkv, const void* wp,
                                    const void* bp, void* y, int G, int N,
                                    int C, int heads, float scale, float eps,
                                    int apply_ln, int dtype, int blocks,
                                    int grids, int smem, void* stream) {
  const Args a = make_args(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y,
                           Geom{0, 0, 0}, G, N, C, heads, scale, eps,
                           apply_ln);
  return fwd(a, dtype, blocks, grids, smem, stream);
}

// The same on x, y [B, H, W, C] with grid size g: the B*g*g windows of
// (H/g)*(W/g) tokens; the plan as for B*g*g grids.
extern "C" int ogvt_attn_branch_nhwc_mma(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv, const void* bqkv, const void* wp, const void* bp,
    void* y, int B, int H, int W, int C, int g, int heads, float scale,
    float eps, int apply_ln, int dtype, int blocks, int grids, int smem,
    void* stream) {
  Geom geo;
  int G, N;
  if (!nhwc_geom(B, H, W, g, &geo, &G, &N)) return cudaErrorInvalidValue;
  const Args a = make_args(x, ln_scale, ln_bias, wqkv, bqkv, wp, bp, y, geo,
                           G, N, C, heads, scale, eps, apply_ln);
  return fwd(a, dtype, blocks, grids, smem, stream);
}
