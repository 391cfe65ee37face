// Two-plane complex banded (DIA) SpMV kernels for Hopper (sm_90a): K5, K6
// and K7 of the port.
//
// Layout as in dia_spmv.cu: a vector is flat, h zeros | n_pad body entries |
// h zeros, with h >= max |offset|, h even and n_pad a multiple of ROW_TILE;
// here the entries are complex, stored interleaved (re, im) as a contiguous
// complex64/complex128 tensor stores them, and read as float2/double2.  A
// complex matrix is two real band planes, A = A_re + i*A_im, each (D, n_pad)
// with the same offsets.  Each plane is stored in its own narrowest exact
// type (f32, bf16 or int8 for complex64 vectors; f64 for complex128) and is
// widened in registers, so a narrow plane gives the products of the same
// values stored wide, bit for bit.
//
// With u the SpMV input and, summed over the bands at the shifted position,
//   rr = A_re*u_re,  ii = A_im*u_im,  ri = A_re*u_im,  ir = A_im*u_re:
// K5  dia_complex_spmv_kernel replaces _dia_complex_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:244, wrapper _dia_complex_pallas_call
//     :447): y = A*x, y_re = rr - ii, y_im = ri + ir.
// K6  dia_complex_dots_kernel<.., YY = false> replaces _dia_complex_dot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:262, wrapper
//     _dia_complex_dotmv_pallas_call :305): K5 and out = conj(x)^T y =
//     [sum xr*yr + xi*yi, sum xr*yi - xi*yr].  CONJ_X computes y = A*conj(x)
//     by a sign fold instead (y_re = rr + ii, y_im = ir - ri; the x planes
//     are read as they are); the same dot is then the Saunders alpha
//     conj(x)^T (A conj(x)).
// K7  dia_complex_dots_kernel<.., YY = true> replaces _dia_complex_wdot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:343, wrapper
//     _dia_complex_wdot_pallas_call :402): K5 on u = dinv*x (complex
//     product, HAS_DINV: the complex Jacobi fold) or on x, and
//     out = [conj(w)^T y, |y|^2 + 0i]; with W_IS_X the dot reads the raw x.
//
// What bounds them on an H100: HBM bytes.  Per row they move
// D * (re_bytes + im_bytes) of bands and 2 * vec_bytes (x and y), plus
// vec_bytes for dinv and for w (K7), at 8 flops per band -- far below any
// compute limit.  On the damped 100^3 Poisson (int8 and bf16 planes, c64)
// that is 37.3 MB for K5 and K6 (11.1 us at 3.35 TB/s) and 45.5 MB for K7
// with the fold and w = x (13.6 us).
//
// K5 (one thread per row, ROW_TILE rows per block, as dia_spmv.cu's first K1)
// reaches 0.64 of its bound and keeps its first design.
//
// K6 and K7 (dia_complex_dots_kernel) are the complex counterpart of
// dia_spmv.cu's dia_dots_kernel:
//  * One launch, deterministic.  Each tile of CDOT_TILE rows gives 2 (K6) or
//    3 (K7) real partials, summed in a fixed tree (warp shuffles, then the
//    first warp over the warps' sums); __threadfence and an integer
//    atomicAdd on a ticket tell the last block to finish.  That block sums
//    the partials in tile order, writes out[] (interleaved complex,
//    straight into the wrapper's result) and resets the ticket to 0 -- the
//    kernel replays inside a CUDA graph.  No float atomics: the dots depend
//    on n_pad alone, not on the grid, the card or the plane storage.  The
//    scratch is the one K2/K3 use on the same stream.
//  * The complex Jacobi fold once per element.  A tile's window of x,
//    CDOT_HALO rows on each side, is staged in shared memory, and under the
//    fold the same window of dinv, folded in place into u = dinv*x by the
//    thread that copied it.  Bands with |offset| <= CDOT_HALO (on the
//    100^3 Poisson: 0, +-1, +-100) read u there; the others read x and
//    dinv from L2 and multiply in registers.  Both use fold(), whose
//    roundings are spelled out, so u is one rounded value whichever path
//    reads it.
//  * The next tile's bytes in flight while this one computes.  Each block
//    walks tiles blockIdx.x, + gridDim.x, ... (one wave of
//    cdot_blocks_per_sm<R>() blocks per SM) through a two-stage pipeline: the
//    window(s) and, where both stages fit the block's share of shared
//    memory, the tile's rows of every band are copied by cp.async (global
//    to shared, no registers) one tile ahead.  One barrier per tile: the
//    warps' partial sums of a tile are summed after the next one's barrier.
//  * Two rows per thread: x, w and y move as one 16-byte float4 (c64) or
//    two double2 (c128), a band pair as 2-16 bytes; an odd offset reads the
//    pair as two float2.
//  * y keeps K5's rounding: the four sums are accumulated in K5's
//    expression and band order, so K6's y is K5's y, K6 with CONJ_X gives
//    K5 on conj(x) (negation is exact in every FMA, and ir - ri equals
//    (-ri) + ir), and K7 without the fold gives K5's y, bit for bit.
// Tried on the H100 (PERF.md, section 6; warm us, K6 with CONJ_X / K7 with
// the fold and w = x; the first K6/K7 kernels and their torch.sum: 25.2 /
// 35.1):
//  - the stage built by plain loads and stores before a barrier, bands
//    read from global memory: 19.4-21.4 / 27.5-35.4 at 8 to 5 blocks per
//    SM (at 8, 32 registers, every variant spilled, the fold 480 bytes);
//    the same with the near bands read from L1: 18.6 / 26.9; with a
//    two-level ticket: no change;
//  - the pipeline without the band rows: 22.7-23.4 / 31.4-31.9;
//  - the pipeline at 2, 3 and 4 blocks per SM: 23.4-23.6 / 33.2-33.4,
//    19.5-20.5 / 29.0-29.2 and 19.1-19.2 / 27.9-28.2 (kept: 4); with
//    three stages (copies two tiles ahead) at 3 and 4: 20.1-20.3 /
//    29.0-33.0;
//  - the far bands' L2 reads cost about 1 / 1.5 of that.
// The launchers allocate nothing and never synchronise; they launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ROW_TILE 256   // as in dia_spmv.cu and ops/padded_dia.py
#define MAX_DIAGS 32
#define CDOT_THREADS 256                 // threads of a K6/K7 block
#define CDOT_TILE (2 * CDOT_THREADS)     // rows of a K6/K7 tile, 2 per thread
#define CDOT_HALO 128                    // staged rows on each side of a tile
#define CDOT_WINDOW (CDOT_TILE + 2 * CDOT_HALO)   // staged entries of a tile
#define TAIL_LOADS 8                     // partials a thread of the last block
                                         // loads at once, per dot
#define SCRATCH_HEAD 256                 // scratch bytes before the partials
                                         // (as in dia_spmv.cu: one ticket)

// K6/K7 blocks that share an SM, by real type (4 in c64, at most 64
// registers a thread; 3 in c128, 85), and the shared memory each may take:
// its share of the SM's 227 KB, less the 1 KB the runtime reserves per block
template <typename R>
__host__ __device__ constexpr int cdot_blocks_per_sm() { return sizeof(R) == 4 ? 4 : 3; }

template <typename R>
__host__ __device__ constexpr int cdot_smem_budget() {
  return (227 << 10) / cdot_blocks_per_sm<R>() - (1 << 10);
}

namespace {

struct Offsets {
  long long off[MAX_DIAGS];
  int nd;
};

template <typename R>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};
template <typename R>
using C = typename Complex<R>::type;

template <typename R>
__device__ __forceinline__ C<R> cplx(R re, R im) {
  C<R> v;
  v.x = re;
  v.y = im;
  return v;
}

template <typename V, typename B>
__device__ __forceinline__ V widen(B b) {
  return static_cast<V>(b);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename R>
struct Sums {
  R rr, ii, ri, ir;
};

// the four real band sums of one row; xi points at row i's body entry
template <typename R, typename BR, typename BI>
__device__ __forceinline__ Sums<R> complex_accumulate(
    const BR* __restrict__ bre, const BI* __restrict__ bim,
    const C<R>* __restrict__ xi, long long i, long long n_pad, const Offsets& offs) {
  Sums<R> s = {R(0), R(0), R(0), R(0)};
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    const C<R> xv = xi[offs.off[d]];
    const long long k = (long long)d * n_pad + i;
    const R br = widen<R>(bre[k]);
    const R bi = widen<R>(bim[k]);
    s.rr = s.rr + br * xv.x;
    s.ii = s.ii + bi * xv.y;
    s.ri = s.ri + br * xv.y;
    s.ir = s.ir + bi * xv.x;
  }
  return s;
}

template <typename R, typename BR, typename BI>
__global__ void __launch_bounds__(ROW_TILE)
dia_complex_spmv_kernel(const BR* __restrict__ bre, const BI* __restrict__ bim,
                        const C<R>* __restrict__ x, C<R>* __restrict__ y,
                        long long n_pad, long long h, Offsets offs) {
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const Sums<R> s = complex_accumulate<R, BR, BI>(bre, bim, x + h + i, i, n_pad, offs);
  y[h + i] = cplx<R>(s.rr - s.ii, s.ri + s.ir);
  if (i < h) {  // h <= n_pad: the first h threads clear both halos
    y[i] = cplx<R>(R(0), R(0));
    y[h + n_pad + i] = cplx<R>(R(0), R(0));
  }
}

// --- K6 and K7 ---------------------------------------------------------------
// the complex entries of a thread's two rows
template <typename R>
struct Pair {
  C<R> v[2];
};

// the pair at p[0], p[1], p 16-byte aligned
__device__ __forceinline__ Pair<float> ld_pair(const float2* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  return {{make_float2(t.x, t.y), make_float2(t.z, t.w)}};
}

__device__ __forceinline__ Pair<double> ld_pair(const double2* p) { return {{p[0], p[1]}}; }

__device__ __forceinline__ void st_pair(float2* p, const Pair<float>& q) {
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0].x, q.v[0].y, q.v[1].x, q.v[1].y);
}

__device__ __forceinline__ void st_pair(double2* p, const Pair<double>& q) {
  p[0] = q.v[0];
  p[1] = q.v[1];
}

// the pair at p[0], p[1]; 16-byte aligned when `aligned` (always so in c128)
template <typename R>
__device__ __forceinline__ Pair<R> ld_pair_any(const C<R>* p, bool aligned) {
  if (sizeof(R) == 8 || aligned) return ld_pair(p);
  return {{p[0], p[1]}};
}

// 16 bytes from global to shared memory without passing registers
// (cp.async), zeros where !in (src must be a valid address either way)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every copy this thread started has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two widened band values of rows i, i + 1 (p 2-element aligned)
__device__ __forceinline__ void ld_band_pair(const int8_t* p, float& b0, float& b1) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  b0 = widen<float>((int8_t)c.x);
  b1 = widen<float>((int8_t)c.y);
}

__device__ __forceinline__ void ld_band_pair(const __nv_bfloat16* p, float& b0, float& b1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  b0 = widen<float>(v.x);
  b1 = widen<float>(v.y);
}

__device__ __forceinline__ void ld_band_pair(const float* p, float& b0, float& b1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  b0 = v.x;
  b1 = v.y;
}

__device__ __forceinline__ void ld_band_pair(const double* p, double& b0, double& b1) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  b0 = v.x;
  b1 = v.y;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// u = dinv * x, the complex Jacobi fold, with its roundings spelled out so
// that the staged and the far bands' u are the same value
template <typename R>
__device__ __forceinline__ C<R> fold(C<R> x, C<R> d) {
  return cplx<R>(fma_rn(x.x, d.x, -mul_rn(x.y, d.y)), fma_rn(x.x, d.y, mul_rn(x.y, d.x)));
}

template <typename R>
__device__ __forceinline__ Pair<R> fold(const Pair<R>& x, const Pair<R>& d) {
  return {{fold<R>(x.v[0], d.v[0]), fold<R>(x.v[1], d.v[1])}};
}

// the pair s[k], s[k + 1] of the staged window (s 16-byte aligned); k & 1
// is the same for every thread of the block, so the branch does not diverge
template <typename R>
__device__ __forceinline__ Pair<R> lds_pair(const C<R>* s, int k) {
  return ld_pair_any<R>(s + k, (k & 1) == 0);
}

// The N sums of one value each per thread over a CDOT_THREADS block, in a
// fixed tree (warp shuffles, then the first warp over the per-warp sums),
// with one barrier for all N.  Valid in thread 0; every thread must call it.
template <typename R, int N>
__device__ __forceinline__ void block_sums(R (&v)[N], R (*smem)[CDOT_THREADS / 32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) smem[j][warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = R(0);
    if (warp == 0) v[j] = warp_sum(lane < CDOT_THREADS / 32 ? smem[j][lane] : R(0));
  }
}

// Bytes of one pipeline stage of a K6/K7 block: the tile's window of x,
// with HAS_DINV the same window of dinv (folded in place into u), and with
// `bands` the tile's rows of every band of both planes.
template <typename R, typename BR, typename BI, bool HAS_DINV>
__host__ __device__ __forceinline__ long long stage_bytes(int nd, bool bands) {
  return (long long)CDOT_WINDOW * sizeof(C<R>) * (HAS_DINV ? 2 : 1) +
         (bands ? (long long)nd * CDOT_TILE * (sizeof(BR) + sizeof(BI)) : 0);
}

// dst[d * CDOT_TILE + j] = src[d * n_pad + r0 + j] for every band d < nd
// and row j of the tile (zeros past n_pad), as cp.async of 16 bytes
template <typename B>
__device__ __forceinline__ void copy_band_rows(B* dst, const B* __restrict__ src,
                                               long long r0, int nd, long long n_pad) {
  constexpr int per = 16 / (int)sizeof(B);   // rows of one copy
  constexpr int cpb = CDOT_TILE / per;       // copies of one band's rows
  for (int c = threadIdx.x; c < nd * cpb; c += CDOT_THREADS) {
    const int d = c / cpb;
    const int j = (c - d * cpb) * per;
    const bool in = r0 + j < n_pad;
    cp_async16(dst + d * CDOT_TILE + j, in ? src + (long long)d * n_pad + r0 + j : src, in);
  }
}

// the pair of entries g, g + 1 of v (zeros outside its len entries) into
// dst, as cp.async
template <typename R>
__device__ __forceinline__ void copy_pair(C<R>* dst, const C<R>* __restrict__ v, long long g,
                                          long long len) {
  const bool in = g >= 0 && g < len;
  const char* src = reinterpret_cast<const char*>(in ? v + g : v);
#pragma unroll
  for (int c = 0; c < 2 * (int)sizeof(C<R>); c += 16)
    cp_async16(reinterpret_cast<char*>(dst) + c, src + c, in);
}

// K6 (!YY) and K7 (YY): y = A*u with u = dinv*x (HAS_DINV) or x, and
// out = [conj(x)^T y] (K6, CONJ_X: y = A*conj(x)) or
// [conj(w)^T y, |y|^2 + 0i] (K7; w read from the raw x when W_IS_X).
// scratch: a ticket (unsigned, 0 between launches) at ticket, and
// NP * n_tiles partials (NP = 2 or 3), dot j of tile k at j * n_tiles + k.
// Dynamic shared memory: two stages of stage_bytes(nd, stage_bands).
template <typename R, typename BR, typename BI, bool CONJ_X, bool HAS_DINV, bool W_IS_X,
          bool YY>
__global__ void __launch_bounds__(CDOT_THREADS, cdot_blocks_per_sm<R>())
dia_complex_dots_kernel(const BR* __restrict__ bre, const BI* __restrict__ bim,
                        const C<R>* __restrict__ x, const C<R>* __restrict__ dinv,
                        const C<R>* __restrict__ w, C<R>* __restrict__ y,
                        C<R>* __restrict__ out, R* __restrict__ partials,
                        unsigned* __restrict__ ticket, long long n_pad, long long h,
                        Offsets offs, int stage_bands) {
  constexpr int NP = YY ? 3 : 2;
  constexpr int WARPS = CDOT_THREADS / 32;
  constexpr int WB = CDOT_WINDOW * (int)sizeof(C<R>);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ R s_p[2][NP][WARPS];   // per-warp sums of a tile, by stage
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nd = offs.nd;
  const long long len = n_pad + 2 * h;
  const long long n_tiles = (n_pad + CDOT_TILE - 1) / CDOT_TILE;
  const long long stride = (long long)gridDim.x * CDOT_THREADS;
  for (long long k = (long long)blockIdx.x * CDOT_THREADS + t; k < h; k += stride) {
    y[k] = cplx<R>(R(0), R(0));
    y[h + n_pad + k] = cplx<R>(R(0), R(0));
  }
  // stage b: the window of x at sx(b); u at su(b) (the window of dinv,
  // folded in place, or x itself); band rows at sre(b), sim(b)
  const long long sb = stage_bytes<R, BR, BI, HAS_DINV>(nd, stage_bands);
  auto sx = [&](int b) { return reinterpret_cast<C<R>*>(smem + b * sb); };
  auto su = [&](int b) { return reinterpret_cast<C<R>*>(smem + b * sb + (HAS_DINV ? WB : 0)); };
  auto sre = [&](int b) {
    return reinterpret_cast<BR*>(smem + b * sb + (HAS_DINV ? 2 : 1) * WB);
  };
  auto sim = [&](int b) {
    return reinterpret_cast<BI*>(smem + b * sb + (HAS_DINV ? 2 : 1) * WB +
                                 (long long)nd * CDOT_TILE * sizeof(BR));
  };
  // the window pair q of this thread: its own (k = 0) and, for the first
  // CDOT_HALO threads, one halo pair (k = 1)
  auto pair_of = [&](int k) {
    return k == 0 ? CDOT_HALO / 2 + t : (t < CDOT_HALO / 2 ? t : CDOT_TILE / 2 + t);
  };
  // start the copies of a tile's stage, rows tile * CDOT_TILE - CDOT_HALO ..
  auto stage = [&](long long tile, int b) {
    const long long r0 = tile * CDOT_TILE;
    for (int k = 0; k < (t < CDOT_HALO ? 2 : 1); ++k) {
      const long long g = h + r0 - CDOT_HALO + 2LL * pair_of(k);
      copy_pair<R>(sx(b) + 2 * pair_of(k), x, g, len);
      if (HAS_DINV) copy_pair<R>(su(b) + 2 * pair_of(k), dinv, g, len);
    }
    if (stage_bands) {
      copy_band_rows(sre(b), bre, r0, nd, n_pad);
      copy_band_rows(sim(b), bim, r0, nd, n_pad);
    }
  };
  // warp 0: sum the per-warp sums of a finished tile into its partials
  auto finish = [&](long long tile, int b) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const R v = warp_sum(lane < WARPS ? s_p[b][j][lane] : R(0));
      if (lane == 0) partials[j * n_tiles + tile] = v;
    }
  };

  long long tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  cp_async_commit();
  int b = 0;
  long long prev = -1;   // the tile whose warp sums wait in s_p[b ^ 1]
  for (; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    cp_async_wait_all();   // this thread's copies of stage b
    if (HAS_DINV) {   // fold the pairs this thread copied, once per entry
      for (int k = 0; k < (t < CDOT_HALO ? 2 : 1); ++k) {
        const int q = 2 * pair_of(k);
        st_pair(su(b) + q, fold<R>(ld_pair(sx(b) + q), ld_pair(su(b) + q)));
      }
    }
    // every copy and fold of stage b is visible, and every read of stage
    // b ^ 1 (the previous tile) is done: the next tile's copies may fly
    // into it while this one computes
    __syncthreads();
    if (tile + gridDim.x < n_tiles) stage(tile + gridDim.x, b ^ 1);
    cp_async_commit();
    if (prev >= 0 && warp == 0) finish(prev, b ^ 1);
    const long long i = tile * CDOT_TILE + 2 * t;  // this thread's rows: i, i + 1
    R p[NP] = {};
    if (i < n_pad) {  // n_pad is even: the pair is whole
      Sums<R> s[2] = {{R(0), R(0), R(0), R(0)}, {R(0), R(0), R(0), R(0)}};
#pragma unroll
      for (int d = 0; d < MAX_DIAGS; ++d) {
        if (d >= nd) break;
        const long long o = offs.off[d];
        R br[2], bi[2];
        if (stage_bands) {
          ld_band_pair(sre(b) + d * CDOT_TILE + 2 * t, br[0], br[1]);
          ld_band_pair(sim(b) + d * CDOT_TILE + 2 * t, bi[0], bi[1]);
        } else {
          ld_band_pair(bre + (long long)d * n_pad + i, br[0], br[1]);
          ld_band_pair(bim + (long long)d * n_pad + i, bi[0], bi[1]);
        }
        Pair<R> u;
        if (o >= -CDOT_HALO && o <= CDOT_HALO) {
          u = lds_pair<R>(su(b), CDOT_HALO + 2 * t + (int)o);
        } else {
          const bool aligned = (o & 1) == 0;
          u = ld_pair_any<R>(x + h + i + o, aligned);
          if (HAS_DINV) u = fold<R>(u, ld_pair_any<R>(dinv + h + i + o, aligned));
        }
        // complex_accumulate's expressions and order, so that y is K5's
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[r].rr = s[r].rr + br[r] * u.v[r].x;
          s[r].ii = s[r].ii + bi[r] * u.v[r].y;
          s[r].ri = s[r].ri + br[r] * u.v[r].y;
          s[r].ir = s[r].ir + bi[r] * u.v[r].x;
        }
      }
      Pair<R> yq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        yq.v[r] = CONJ_X ? cplx<R>(s[r].rr + s[r].ii, s[r].ir - s[r].ri)
                         : cplx<R>(s[r].rr - s[r].ii, s[r].ri + s[r].ir);
      st_pair(y + h + i, yq);
      const Pair<R> wq = W_IS_X ? lds_pair<R>(sx(b), CDOT_HALO + 2 * t) : ld_pair(w + h + i);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const C<R> a = wq.v[r], c = yq.v[r];
        p[0] = p[0] + (a.x * c.x + a.y * c.y);
        p[1] = p[1] + (a.x * c.y - a.y * c.x);
        if (YY) p[NP - 1] = p[NP - 1] + (c.x * c.x + c.y * c.y);
      }
    }
    // the warp sums wait in s_p[b] for the next barrier (the cross-warp sum
    // in a fixed tree, as block_sums)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const R v = warp_sum(p[j]);
      if (lane == 0) s_p[b][j][warp] = v;
    }
    prev = tile;
  }
  __syncthreads();
  if (prev >= 0 && warp == 0) finish(prev, b ^ 1);
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every partial is in L2 (read past L1 with __ldcg); sum
  // them in tile order, thread t taking tiles t, t + CDOT_THREADS, ...,
  // with TAIL_LOADS of them in flight at once
  R q[NP] = {};
  for (long long k0 = t; k0 < n_tiles; k0 += TAIL_LOADS * CDOT_THREADS) {
    R v[TAIL_LOADS][NP];
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
      const long long k = k0 + (long long)u * CDOT_THREADS;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        v[u][j] = k < n_tiles ? __ldcg(partials + j * n_tiles + k) : R(0);
    }
#pragma unroll
    for (int u = 0; u < TAIL_LOADS; ++u) {
#pragma unroll
      for (int j = 0; j < NP; ++j) q[j] = q[j] + v[u][j];
    }
  }
  block_sums<R, NP>(q, s_p[0]);
  if (t == 0) {
    out[0] = cplx<R>(q[0], q[1]);
    if (YY) out[1] = cplx<R>(q[NP - 1], R(0));
    *ticket = 0u;
  }
}

dim3 grid_of(long long n_pad) { return dim3((unsigned)(n_pad / ROW_TILE)); }

template <typename R, typename BR, typename BI>
struct SpmvLaunch {
  static void run(const void* bre, const void* bim, const void* x, void* y,
                  long long n_pad, long long h, const Offsets& o, cudaStream_t s) {
    dia_complex_spmv_kernel<R, BR, BI><<<grid_of(n_pad), ROW_TILE, 0, s>>>(
        (const BR*)bre, (const BI*)bim, (const C<R>*)x, (C<R>*)y, n_pad, h, o);
  }
};

struct DotArgs {
  const void *bre, *bim, *x, *dinv, *w;
  void *y, *out, *scratch;
  long long scratch_bytes;
  int grid;
  long long n_pad, h;
  Offsets o;
  cudaStream_t s;
};

template <typename R, typename BR, typename BI, bool CONJ_X, bool HAS_DINV, bool W_IS_X,
          bool YY>
void dots_op(const DotArgs& a) {
  const auto kernel = dia_complex_dots_kernel<R, BR, BI, CONJ_X, HAS_DINV, W_IS_X, YY>;
  // the band rows are staged when both stages fit the block's share of the
  // SM's shared memory; otherwise the bands are read from global memory
  const bool bands =
      2 * stage_bytes<R, BR, BI, HAS_DINV>(a.o.nd, true) <= cdot_smem_budget<R>();
  const int smem = (int)(2 * stage_bytes<R, BR, BI, HAS_DINV>(a.o.nd, bands));
  if (smem > (47 << 10))   // above the default limit: opt in on this device
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  char* sc = (char*)a.scratch;
  kernel<<<a.grid, CDOT_THREADS, smem, a.s>>>(
      (const BR*)a.bre, (const BI*)a.bim, (const C<R>*)a.x, (const C<R>*)a.dinv,
      (const C<R>*)a.w, (C<R>*)a.y, (C<R>*)a.out, (R*)(sc + SCRATCH_HEAD), (unsigned*)sc,
      a.n_pad, a.h, a.o, (int)bands);
}

// kind 0, 1: K6 with conj_x = kind; 2-5: K7 with kind = 2 + 2 * has_dinv + w_is_x
template <typename R, typename BR, typename BI>
struct DotsLaunch {
  static void run(int kind, const DotArgs& a) {
    switch (kind) {
      case 0: dots_op<R, BR, BI, false, false, true, false>(a); break;
      case 1: dots_op<R, BR, BI, true, false, true, false>(a); break;
      case 2: dots_op<R, BR, BI, false, false, false, true>(a); break;
      case 3: dots_op<R, BR, BI, false, false, true, true>(a); break;
      case 4: dots_op<R, BR, BI, false, true, false, true>(a); break;
      default: dots_op<R, BR, BI, false, true, true, true>(a); break;
    }
  }
};

// Runs L<R, BR, BI>::run(args...) for the vector type code and the two
// plane type codes; false for a combination the kernels do not take.
// vcode 0 = complex64 vectors with planes of code 0 = f32, 1 = bf16,
// 2 = int8 each; vcode 1 = complex128 vectors with f64 planes (code 0).
template <template <typename, typename, typename> class L, typename... A>
bool dispatch(int vcode, int re_code, int im_code, A... args) {
  if (vcode == 1) {
    if (re_code != 0 || im_code != 0) return false;
    L<double, double, double>::run(args...);
    return true;
  }
  if (vcode != 0) return false;
  switch (re_code * 3 + im_code) {
    case 0: L<float, float, float>::run(args...); return true;
    case 1: L<float, float, __nv_bfloat16>::run(args...); return true;
    case 2: L<float, float, int8_t>::run(args...); return true;
    case 3: L<float, __nv_bfloat16, float>::run(args...); return true;
    case 4: L<float, __nv_bfloat16, __nv_bfloat16>::run(args...); return true;
    case 5: L<float, __nv_bfloat16, int8_t>::run(args...); return true;
    case 6: L<float, int8_t, float>::run(args...); return true;
    case 7: L<float, int8_t, __nv_bfloat16>::run(args...); return true;
    case 8: L<float, int8_t, int8_t>::run(args...); return true;
    default: return false;
  }
}

Offsets make_offsets(const long long* offsets, int nd) {
  Offsets o;
  o.nd = nd;
  for (int d = 0; d < MAX_DIAGS; ++d) o.off[d] = d < nd ? offsets[d] : 0;
  return o;
}

bool bad_geometry(long long n_pad, long long h, int nd) {
  return nd < 0 || nd > MAX_DIAGS || n_pad <= 0 || n_pad % ROW_TILE != 0 ||
         h < 0 || h > n_pad || n_pad / ROW_TILE > 0x7fffffffLL;
}

bool bad_codes(int re_code, int im_code) {
  return re_code < 0 || re_code > 2 || im_code < 0 || im_code > 2;
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15u) != 0; }

int launch_dots(int vcode, int re_code, int im_code, int kind, DotArgs& a,
                const long long* offsets, int nd) {
  const long long rbytes = vcode == 1 ? 8 : 4;
  const long long n_tiles = (a.n_pad + CDOT_TILE - 1) / CDOT_TILE;
  const long long np = kind < 2 ? 2 : 3;
  if (bad_geometry(a.n_pad, a.h, nd) || bad_codes(re_code, im_code) || a.grid < 1 ||
      a.scratch_bytes < SCRATCH_HEAD + np * n_tiles * rbytes)
    return (int)cudaErrorInvalidValue;
  if (misaligned(a.bre) || misaligned(a.bim) || misaligned(a.x) || misaligned(a.dinv) ||
      misaligned(a.w) || misaligned(a.y) || misaligned(a.out) || misaligned(a.scratch) ||
      a.h % 2 != 0)
    return (int)cudaErrorMisalignedAddress;
  a.o = make_offsets(offsets, nd);
  if (!dispatch<DotsLaunch>(vcode, re_code, im_code, kind, a))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Type codes as in dispatch() above; bre/bim are the two band planes.

extern "C" int sprsolve_dia_complex_spmv(int vcode, int re_code, int im_code,
                                         const void* bre, const void* bim,
                                         const void* x, void* y, long long n_pad,
                                         long long h, const long long* offsets,
                                         int nd, void* stream) {
  if (bad_geometry(n_pad, h, nd) || bad_codes(re_code, im_code))
    return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  if (!dispatch<SpmvLaunch>(vcode, re_code, im_code, bre, bim, x, y, n_pad, h,
                            o, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sprsolve_dia_complex_dots_tile() { return CDOT_TILE; }

// K6/K7 blocks that share an SM, by vector type code
extern "C" int sprsolve_dia_complex_dots_blocks_per_sm(int vcode) {
  return vcode == 1 ? cdot_blocks_per_sm<double>() : cdot_blocks_per_sm<float>();
}

// K6.  out: one complex value, conj(x)^T y.  scratch: the caller's
// per-stream area of scratch_bytes >= SCRATCH_HEAD + 2 * tiles * sizeof(R)
// bytes (tiles of CDOT_TILE rows), zero before its first launch (each
// launch leaves the ticket so).  grid: at least 1 block; the dot does not
// depend on it.  h must be even.
extern "C" int sprsolve_dia_complex_dot(int vcode, int re_code, int im_code,
                                        int conj_x, const void* bre,
                                        const void* bim, const void* x, void* y,
                                        void* out, void* scratch,
                                        long long scratch_bytes, int grid,
                                        long long n_pad, long long h,
                                        const long long* offsets, int nd,
                                        void* stream) {
  DotArgs a{bre, bim, x, nullptr, nullptr, y, out, scratch, scratch_bytes, grid, n_pad,
            h, {}, (cudaStream_t)stream};
  return launch_dots(vcode, re_code, im_code, conj_x != 0, a, offsets, nd);
}

// K7.  dinv == nullptr: no Jacobi fold; w == nullptr: the dot reads x
// (w_is_x).  out: two complex values, [conj(w)^T y, |y|^2 + 0i].  scratch
// as for sprsolve_dia_complex_dot, with 3 * tiles partials.
extern "C" int sprsolve_dia_complex_wdot(int vcode, int re_code, int im_code,
                                         const void* bre, const void* bim,
                                         const void* x, const void* dinv,
                                         const void* w, void* y, void* out,
                                         void* scratch, long long scratch_bytes,
                                         int grid, long long n_pad, long long h,
                                         const long long* offsets, int nd,
                                         void* stream) {
  DotArgs a{bre, bim, x, dinv, w, y, out, scratch, scratch_bytes, grid, n_pad, h, {},
            (cudaStream_t)stream};
  const int kind = 2 + 2 * (dinv != nullptr) + (w == nullptr);
  return launch_dots(vcode, re_code, im_code, kind, a, offsets, nd);
}
