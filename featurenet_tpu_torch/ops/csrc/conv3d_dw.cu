// Weight gradient of the stride-1 SAME 3D convolution, odd K, fp32 in /
// fp32 accumulate / fp32 out, for Hopper (sm_90a).
//
// Replaces featurenet_tpu/ops/conv3d.py::_conv_dw (Pallas body _dw_kernel):
//   dW[dz,dy,dx,ci,co] = sum over positions (b,z,y,x) of
//       x[b, z+dz-p, y+dy-p, x+dx-p, ci] * g[b, z, y, x, co]   (p = (K-1)/2)
// with zero padding outside the grid. Layouts are the JAX ones: x NDHWC
// ([B,D,H,W,Cin]), g NDHWC ([B,D,H,W,Cout]), dW DHWIO ([K,K,K,Cin,Cout]);
// all contiguous.
//
// What bounds it on this card: operations (2*K^3*Cin*Cout flops per
// position against (Cin+Cout)*4 bytes read; several hundred flop/byte at
// sprint64's shapes, far above the ~20 flop/byte fp32 ridge). What is hard
// is the shape: the sum runs over M = B*D*H*W positions (about a million at
// batch 256) into an output of only K^3*Cin*Cout values (at most 110,592
// here), so tiles over the output alone give a handful of blocks for 132
// SMs. The TPU kernel carries its sum across a sequential batch grid; GPU
// blocks run in parallel and in no order. So:
//
// - The GEMM is dW[(tap,ci), co] = sum_m A[m, (tap,ci)] * g[m, co], with
//   A[m, (tap,ci)] the tap-shifted input. A block owns a BM x BN tile of
//   (tap,ci) rows x Cout columns (BN = 32 or 64, BM = 256 or 128) and one
//   slab of positions; there are S slabs, chosen by the caller so that
//   tiles x S fills the card.
// - Each block writes its partial tile to part[slab][(tap,ci)][co]; a second
//   kernel sums the S partials of each output in slab order. Two runs give
//   the same bits (atomics would not).
// - Positions are walked in chunks of BK = 16 through shared memory; the
//   halo is bounds checks on the shifted coordinate (zero outside), as in
//   conv3d_fwd.cu, so no padded copy of x exists in device memory.
// - Each of the 256 threads accumulates an 8 x 4 register tile.
//
// Plain, not fast yet: SIMT fp32, no cp.async/TMA pipelining, no tensor
// cores (the TPU kernel is fp32 and so is this one).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kTM = 8;         // output rows per thread
constexpr int kTN = 4;         // output columns per thread
constexpr int kBK = 16;        // positions per shared-memory chunk
constexpr int kAPad = 4;       // keeps float4 alignment, spreads banks
constexpr int kOutside = -(1 << 28);  // coordinate that fails every bound

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_dw_partial(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, int B, int D, int H, int W,
                  int Cin, int Cout, int K, long long slab_len) {
  constexpr int BM = kThreads * kTM * kTN / BN;  // 256 (BN=32) or 128 (BN=64)
  constexpr int TX = BN / kTN;                   // threads across columns
  constexpr int A_STEP = kThreads / BM;          // chunk rows per A pass
  constexpr int A_PASSES = kBK / A_STEP;
  constexpr int B_STEP = kThreads / BN;
  constexpr int B_PASSES = kBK / B_STEP;

  __shared__ __align__(16) float As[kBK][BM + kAPad];
  __shared__ __align__(16) float Bs[kBK][BN];
  __shared__ long long s_m[kBK];  // position index, -1 past the slab
  __shared__ int s_z[kBK], s_y[kBK], s_x[kBK];

  const int tid = threadIdx.x;
  const int rows = K * K * K * Cin;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)B * D * H * W;
  const long long m_begin = (long long)blockIdx.z * slab_len;
  const long long m_end = m_begin + slab_len < M ? m_begin + slab_len : M;
  const int p = (K - 1) / 2;

  // This thread's A row (tap, ci) is the same for every chunk.
  const int a_r = tid % BM, a_k0 = tid / BM;
  const int row = r0 + a_r;
  const bool row_ok = row < rows;
  const int tap = row_ok ? row / Cin : 0;
  const int ci = row_ok ? row % Cin : 0;
  const int dz = tap / (K * K) - p;
  const int dy = (tap / K) % K - p;
  const int dx = tap % K - p;
  const long long a_off =
      (((long long)dz * H + dy) * W + dx) * Cin + ci;  // shift + channel
  const int b_n = tid % BN, b_k0 = tid / BN;
  const bool col_ok = n0 + b_n < Cout;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int tx = tid % TX, ty = tid / TX;

  for (long long c0 = m_begin; c0 < m_end; c0 += kBK) {
    if (tid < kBK) {
      const long long m = c0 + tid;
      if (m < m_end) {
        long long t = m;
        s_x[tid] = (int)(t % W);
        t /= W;
        s_y[tid] = (int)(t % H);
        t /= H;
        s_z[tid] = (int)(t % D);
        s_m[tid] = m;
      } else {
        s_x[tid] = s_y[tid] = s_z[tid] = kOutside;
        s_m[tid] = -1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const int k = a_k0 + i * A_STEP;
      const int zz = s_z[k] + dz, yy = s_y[k] + dy, xx = s_x[k] + dx;
      float v = 0.f;
      if (row_ok && (unsigned)zz < (unsigned)D && (unsigned)yy < (unsigned)H &&
          (unsigned)xx < (unsigned)W)
        v = __ldg(x + s_m[k] * Cin + a_off);
      As[k][a_r] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int k = b_k0 + i * B_STEP;
      const long long m = s_m[k];
      float v = 0.f;
      if (col_ok && m >= 0) v = __ldg(g + m * Cout + n0 + b_n);
      Bs[k][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // No third barrier: the next chunk's position writes touch only s_*,
    // which no thread reads after the barrier above, and its tile writes
    // come after the next barrier, which every thread reaches only once
    // it has finished reading this chunk's tiles.
  }

  float* out = part + (long long)blockIdx.z * rows * Cout;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < Cout) out[(long long)r * Cout + n] = acc[i][j];
    }
  }
}

// out[i] = sum over s = 0..S-1, in that order, of part[s][i].
__global__ void __launch_bounds__(kThreads)
sum_slabs(const float* __restrict__ part, float* __restrict__ out, long long n,
          int S) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldg(part + (long long)k * n + i);
  out[i] = s;
}

template <int BN>
void launch_partial(const float* x, const float* g, float* part, int B, int D,
                    int H, int W, int Cin, int Cout, int K, int S,
                    long long slab_len, cudaStream_t stream) {
  constexpr int BM = kThreads * kTM * kTN / BN;
  const int rows = K * K * K * Cin;
  const dim3 grid((unsigned)((rows + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN), (unsigned)S);
  conv3d_dw_partial<BN><<<grid, kThreads, 0, stream>>>(
      x, g, part, B, D, H, W, Cin, Cout, K, slab_len);
}

}  // namespace

// C entry bound with ctypes. `part` is caller-allocated scratch of
// S * K^3 * Cin * Cout floats; slab s covers positions
// [s*slab_len, min((s+1)*slab_len, B*D*H*W)). `bn` (32 or 64) is the
// column tile the caller planned S with. Launches the partial kernel, then
// the slab sum, on `stream`; does not synchronise, allocates nothing;
// returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int conv3d_dw_f32(const float* x, const float* g, float* part,
                             float* out, int B, int D, int H, int W, int Cin,
                             int Cout, int K, int bn, int S, long long slab_len,
                             void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || K < 1 ||
      K % 2 == 0 || S < 1 || S > 65535 || slab_len < 1 ||
      (long long)(S - 1) * slab_len >= (long long)B * D * H * W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 32)
    launch_partial<32>(x, g, part, B, D, H, W, Cin, Cout, K, S, slab_len, s);
  else if (bn == 64)
    launch_partial<64>(x, g, part, B, D, H, W, Cin, Cout, K, S, slab_len, s);
  else
    return (int)cudaErrorInvalidValue;
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long n = (long long)K * K * K * Cin * Cout;
  sum_slabs<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, out, n, S);
  return (int)cudaGetLastError();
}
