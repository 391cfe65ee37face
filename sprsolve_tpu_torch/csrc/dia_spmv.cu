// Banded (DIA) SpMV kernels for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Layout (see sprsolve_tpu_torch/ops/padded_dia.py): a vector is flat,
// h zeros | n_pad body entries | h zeros, with h >= max |offset| and n_pad a
// multiple of ROW_TILE.  Bands are (D, n_pad), row-major, zero outside the
// matrix.  Band storage may be narrower than the vector type (int8 or bf16
// for f32 vectors); narrowing is exact, so widening in registers gives the
// same products bit for bit.
//
// K1  dia_spmv_kernel replaces _dia_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:131, wrapper _dia_pallas_call :509):
//     y[h + i] = sum_d widen(band[d][i]) * x[h + i + off_d].
// K2  dia_wdot_kernel replaces _dia_wdot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:159, wrapper _dia_wdot_pallas_call :194):
//     K1 on u = dinv * x (HAS_DINV) or on x, plus one pair of partials per
//     block, [sum w*y, sum y*y]; with W_IS_X the dot reads the raw x, as
//     w_ref = x_ref does on the TPU.
// K3  dia_dot_kernel replaces _dia_dot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:140, wrapper _dia_dotmv_pallas_call
//     :474): K1 plus one partial per block of sum x*y, with x the raw body
//     of the SpMV input (jnp.sum(x_ref[hr:hr+br] * acc) on the TPU) -- the
//     mkl_sparse_?_dotmv analog behind MINRES's and CG's alpha.
//
// What bounds them on an H100: HBM bytes.  Per row they move
// D * band_bytes + 2 * vec_bytes (K1 and K3), plus vec_bytes for dinv and
// for w (K2), at 2 flops per band: far below any compute limit.  K3's dot
// adds no stream: x's body entry is one load away in L1, already fetched
// by the off = 0 band.  The design:
//  * one thread per row, ROW_TILE rows per block, so every band row, the
//    x body and y are read and written fully coalesced;
//  * the D shifted reads of x (and dinv) overlap between neighbouring rows
//    and bands; they are served from L1/L2, so x costs about one HBM pass;
//  * int8/bf16 band storage cuts the dominant band stream 4x/2x;
//  * the offsets live in the kernel's parameter space and the band loop is
//    unrolled to MAX_DIAGS with an early exit, so no offset is indexed
//    dynamically;
//  * K2's and K3's reductions use a fixed tree (block_sum: warp shuffles,
//    then shared memory) and write one partial per block and sum; the
//    caller sums the partials in a second, fixed-order step.  No float
//    atomics, so a solve's iteration count does not change from run to run.
// The launchers allocate nothing and never synchronise; they launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ROW_TILE 256
#define MAX_DIAGS 32

namespace {

struct Offsets {
  long long off[MAX_DIAGS];
  int nd;
};

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

// Sum of one value per thread over a ROW_TILE block, in a fixed tree: warp
// shuffles, then the first warp over the per-warp sums in shared memory
// (smem holds ROW_TILE / 32 values).  The block's sum is valid in thread 0.
// Every thread of the block must call it.  fused.cu keeps a copy, so that
// each source builds alone.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = V(0);
  if (warp == 0) {
    v = lane < ROW_TILE / 32 ? smem[lane] : V(0);
    v = warp_sum(v);
  }
  return v;
}

// sum over the band loop for one row; xi and di point at row i's body entry
template <typename V, typename B, bool HAS_DINV>
__device__ __forceinline__ V band_accumulate(const B* __restrict__ bands,
                                             const V* __restrict__ xi,
                                             const V* __restrict__ di,
                                             long long i, long long n_pad,
                                             const Offsets& offs) {
  V acc = V(0);
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    const long long o = offs.off[d];
    V xv = xi[o];
    if (HAS_DINV) xv = xv * di[o];
    acc = acc + widen<V>(bands[(long long)d * n_pad + i]) * xv;
  }
  return acc;
}

template <typename V, typename B>
__global__ void __launch_bounds__(ROW_TILE)
dia_spmv_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                V* __restrict__ y, long long n_pad, long long h, Offsets offs) {
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  y[h + i] = band_accumulate<V, B, false>(bands, x + h + i, nullptr, i, n_pad, offs);
  if (i < h) {  // h <= n_pad: the first h threads clear both halos
    y[i] = V(0);
    y[h + n_pad + i] = V(0);
  }
}

template <typename V, typename B, bool HAS_DINV, bool W_IS_X>
__global__ void __launch_bounds__(ROW_TILE)
dia_wdot_kernel(const B* __restrict__ bands, const V* __restrict__ x,
                const V* __restrict__ dinv, const V* __restrict__ w,
                V* __restrict__ y, V* __restrict__ partials, long long n_pad,
                long long h, Offsets offs) {
  __shared__ V s_w[ROW_TILE / 32];
  __shared__ V s_y[ROW_TILE / 32];
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const V acc = band_accumulate<V, B, HAS_DINV>(
      bands, x + h + i, HAS_DINV ? dinv + h + i : nullptr, i, n_pad, offs);
  y[h + i] = acc;
  if (i < h) {
    y[i] = V(0);
    y[h + n_pad + i] = V(0);
  }
  const V wv = W_IS_X ? x[h + i] : w[h + i];
  const V pw = block_sum(wv * acc, s_w);
  const V py = block_sum(acc * acc, s_y);
  if (threadIdx.x == 0) {
    partials[2 * (long long)blockIdx.x] = pw;
    partials[2 * (long long)blockIdx.x + 1] = py;
  }
}

template <typename V, typename B>
__global__ void __launch_bounds__(ROW_TILE)
dia_dot_kernel(const B* __restrict__ bands, const V* __restrict__ x,
               V* __restrict__ y, V* __restrict__ partials, long long n_pad,
               long long h, Offsets offs) {
  __shared__ V s_d[ROW_TILE / 32];
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const V acc = band_accumulate<V, B, false>(bands, x + h + i, nullptr, i, n_pad, offs);
  y[h + i] = acc;
  if (i < h) {
    y[i] = V(0);
    y[h + n_pad + i] = V(0);
  }
  const V pd = block_sum(x[h + i] * acc, s_d);
  if (threadIdx.x == 0) partials[blockIdx.x] = pd;
}

Offsets make_offsets(const long long* offsets, int nd) {
  Offsets o;
  o.nd = nd;
  for (int d = 0; d < MAX_DIAGS; ++d) o.off[d] = d < nd ? offsets[d] : 0;
  return o;
}

template <typename V, typename B>
void launch_spmv(const void* bands, const void* x, void* y, long long n_pad,
                 long long h, const Offsets& o, cudaStream_t s) {
  dia_spmv_kernel<V, B><<<(unsigned)(n_pad / ROW_TILE), ROW_TILE, 0, s>>>(
      (const B*)bands, (const V*)x, (V*)y, n_pad, h, o);
}

template <typename V, typename B>
void launch_wdot(const void* bands, const void* x, const void* dinv,
                 const void* w, void* y, void* partials, long long n_pad,
                 long long h, const Offsets& o, cudaStream_t s) {
  const dim3 grid((unsigned)(n_pad / ROW_TILE));
  const B* b = (const B*)bands;
  const V* xv = (const V*)x;
  const V* dv = (const V*)dinv;
  const V* wv = (const V*)w;
  V* yv = (V*)y;
  V* pv = (V*)partials;
  if (dinv && w)
    dia_wdot_kernel<V, B, true, false><<<grid, ROW_TILE, 0, s>>>(b, xv, dv, wv, yv, pv, n_pad, h, o);
  else if (dinv)
    dia_wdot_kernel<V, B, true, true><<<grid, ROW_TILE, 0, s>>>(b, xv, dv, wv, yv, pv, n_pad, h, o);
  else if (w)
    dia_wdot_kernel<V, B, false, false><<<grid, ROW_TILE, 0, s>>>(b, xv, dv, wv, yv, pv, n_pad, h, o);
  else
    dia_wdot_kernel<V, B, false, true><<<grid, ROW_TILE, 0, s>>>(b, xv, dv, wv, yv, pv, n_pad, h, o);
}

template <typename V, typename B>
void launch_dot(const void* bands, const void* x, void* y, void* partials,
                long long n_pad, long long h, const Offsets& o, cudaStream_t s) {
  dia_dot_kernel<V, B><<<(unsigned)(n_pad / ROW_TILE), ROW_TILE, 0, s>>>(
      (const B*)bands, (const V*)x, (V*)y, (V*)partials, n_pad, h, o);
}

bool bad_geometry(long long n_pad, long long h, int nd) {
  return nd < 0 || nd > MAX_DIAGS || n_pad <= 0 || n_pad % ROW_TILE != 0 ||
         h < 0 || h > n_pad || n_pad / ROW_TILE > 0x7fffffffLL;
}

}  // namespace

// Type codes: vcode 0 = f32, 1 = f64 vectors; bcode 0 = bands of the vector
// type, 1 = bf16, 2 = int8 (both for f32 vectors only).

extern "C" int sprsolve_dia_row_tile() { return ROW_TILE; }

extern "C" int sprsolve_dia_max_diags() { return MAX_DIAGS; }

extern "C" const char* sprsolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int sprsolve_dia_spmv(int vcode, int bcode, const void* bands,
                                 const void* x, void* y, long long n_pad,
                                 long long h, const long long* offsets, int nd,
                                 void* stream) {
  if (bad_geometry(n_pad, h, nd)) return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0 && bcode == 0) launch_spmv<float, float>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 1) launch_spmv<float, __nv_bfloat16>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 2) launch_spmv<float, int8_t>(bands, x, y, n_pad, h, o, s);
  else if (vcode == 1 && bcode == 0) launch_spmv<double, double>(bands, x, y, n_pad, h, o, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dinv == nullptr: no Jacobi fold; w == nullptr: the dot reads x (w_is_x).
extern "C" int sprsolve_dia_wdot(int vcode, int bcode, const void* bands,
                                 const void* x, const void* dinv, const void* w,
                                 void* y, void* partials, long long n_pad,
                                 long long h, const long long* offsets, int nd,
                                 void* stream) {
  if (bad_geometry(n_pad, h, nd)) return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0 && bcode == 0) launch_wdot<float, float>(bands, x, dinv, w, y, partials, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 1) launch_wdot<float, __nv_bfloat16>(bands, x, dinv, w, y, partials, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 2) launch_wdot<float, int8_t>(bands, x, dinv, w, y, partials, n_pad, h, o, s);
  else if (vcode == 1 && bcode == 0) launch_wdot<double, double>(bands, x, dinv, w, y, partials, n_pad, h, o, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// partials: n_pad / ROW_TILE values, one sum of x*y per block.
extern "C" int sprsolve_dia_dot(int vcode, int bcode, const void* bands,
                                const void* x, void* y, void* partials,
                                long long n_pad, long long h,
                                const long long* offsets, int nd, void* stream) {
  if (bad_geometry(n_pad, h, nd)) return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0 && bcode == 0) launch_dot<float, float>(bands, x, y, partials, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 1) launch_dot<float, __nv_bfloat16>(bands, x, y, partials, n_pad, h, o, s);
  else if (vcode == 0 && bcode == 2) launch_dot<float, int8_t>(bands, x, y, partials, n_pad, h, o, s);
  else if (vcode == 1 && bcode == 0) launch_dot<double, double>(bands, x, y, partials, n_pad, h, o, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
