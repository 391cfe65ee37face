// Fused Lanczos step for Hopper (sm_90a): K4 of the port.
//
// Layout as in dia_spmv.cu: vectors are flat, h zeros | n_pad body entries |
// h zeros, with n_pad a multiple of ROW_TILE.
//
// K4  orth_norm_kernel replaces _orth_norm_kernel
//     (sprsolve_tpu/ops/pallas_fused.py:37, wrapper fused_orth_norm_call :58):
//     out = a - beta * v_old - alpha * v over the body entries, plus one
//     partial per block of sum out*out -- MINRES's orthogonalisation and the
//     norm of the next Lanczos vector in one pass.
//
// What bounds it on an H100: HBM bytes.  It streams 3 reads and 1 write per
// entry at 5 flops: a pure streaming pass.  The design:
//  * one thread per entry, ROW_TILE entries per block, so every load and the
//    store are fully coalesced;
//  * beta and alpha are device pointers to 0-d tensors, read once per block
//    by thread 0 into shared memory -- the launch needs no host read of
//    either (on the TPU they arrived in SMEM straight from K3's partial sum);
//  * the block's sum of squares goes through the fixed tree of dia_spmv.cu
//    (block_sum, copied here so that each source builds alone) into
//    partials[block]; the caller sums the partials in a second step, with
//    no float atomics;
//  * the first h threads clear both halos of the output, so the wrapper can
//    allocate it with torch.empty and pad coordinates stay exactly zero.
// The launcher allocates nothing and never synchronises; it launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#define ROW_TILE 256  // as in dia_spmv.cu and ops/padded_dia.py

namespace {

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// dia_spmv.cu's block_sum: the block's sum in thread 0, in a fixed tree
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

template <typename V>
__global__ void __launch_bounds__(ROW_TILE)
orth_norm_kernel(const V* __restrict__ a, const V* __restrict__ vold,
                 const V* __restrict__ v, const V* __restrict__ beta,
                 const V* __restrict__ alpha, V* __restrict__ out,
                 V* __restrict__ partials, long long n_pad, long long h) {
  __shared__ V s_coef[2];
  __shared__ V s_p[ROW_TILE / 32];
  if (threadIdx.x == 0) {
    s_coef[0] = *beta;
    s_coef[1] = *alpha;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const long long k = h + i;
  const V vn = a[k] - s_coef[0] * vold[k] - s_coef[1] * v[k];
  out[k] = vn;
  if (i < h) {  // h <= n_pad: the first h threads clear both halos
    out[i] = V(0);
    out[h + n_pad + i] = V(0);
  }
  const V ps = block_sum(vn * vn, s_p);
  if (threadIdx.x == 0) partials[blockIdx.x] = ps;
}

template <typename V>
void launch_orth_norm(const void* a, const void* vold, const void* v,
                      const void* beta, const void* alpha, void* out,
                      void* partials, long long n_pad, long long h,
                      cudaStream_t s) {
  orth_norm_kernel<V><<<(unsigned)(n_pad / ROW_TILE), ROW_TILE, 0, s>>>(
      (const V*)a, (const V*)vold, (const V*)v, (const V*)beta,
      (const V*)alpha, (V*)out, (V*)partials, n_pad, h);
}

}  // namespace

// vcode 0 = f32, 1 = f64 (vectors, beta and alpha alike); partials holds
// n_pad / ROW_TILE values, one sum of out*out per block.
extern "C" int sprsolve_orth_norm(int vcode, const void* a, const void* vold,
                                  const void* v, const void* beta,
                                  const void* alpha, void* out, void* partials,
                                  long long n_pad, long long h, void* stream) {
  if (n_pad <= 0 || n_pad % ROW_TILE != 0 || h < 0 || h > n_pad ||
      n_pad / ROW_TILE > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vcode == 0) launch_orth_norm<float>(a, vold, v, beta, alpha, out, partials, n_pad, h, s);
  else if (vcode == 1) launch_orth_norm<double>(a, vold, v, beta, alpha, out, partials, n_pad, h, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
