// Tap-folded weight gradient of the stride-1 SAME 3D convolution, odd K,
// bf16 or fp32 in / fp32 accumulate / fp32 out, for Hopper (sm_90a).
//
// Replaces featurenet_tpu/ops/conv_dw.py::conv_dw_folded (Pallas body
// _dw_folded_kernel). It computes the same dW as conv3d_dw.cu,
//   dW[tz,ty,tx,ci,co] = sum_(b,z,y,x) x[b,z+tz-p,y+ty-p,x+tx-p,ci] * g[b,z,y,x,co],
// written, as the TPU kernel writes it, as one matrix product with the x
// taps folded onto the output columns. The sum runs over
// q = (b, z, y, u), u over the x extent padded by p on each side:
//   A[q, (tz,ty,ci)] = x[b, z+tz-p, y+ty-p, u-p, ci]   (zero outside)
//   Bm[q, (tx,co)]   = g[b, z, y, u-tx, co]            (zero outside)
//   dWf = A^T Bm, shape [K^2*Cin, K*Cout], un-folded to [K,K,K,Cin,Cout].
// Layouts are the JAX ones: x NDHWC, g NDHWC, dW DHWIO; all contiguous; x
// and g share one type. A bf16 product is exact in fp32 (8-bit mantissas),
// so the bf16 path multiplies as the MXU does and sums in fp32.
//
// What bounds it on this card: operations. The TPU kernel's tap folding and
// host-side z-window restack exist for the MXU's 128-wide tiles and for
// VMEM; neither limit exists here, so only the folded product is kept and
// the blocking is planned for shared memory:
//
// - A block owns a BM x BN tile of dWf (BN = 32, 64 or 128 columns, BM =
//   8192/BN rows; the caller picks the pair that pads dWf least) and one
//   slab of the sum; S slabs are chosen by the caller to fill 132 SMs.
// - The halo in z, y (A) and x (Bm) is bounds checks, so no padded or
//   restacked copy of x is made in device memory.
// - Each block writes its partial tile; a second kernel sums the S
//   partials in slab order and un-folds into [K,K,K,Cin,Cout] in the same
//   pass. Two runs give the same bits.
//
// bf16 (the main path, hybrid_dw): tensor cores, as the MXU runs it. The
// sum is walked in chunks of 32 q-rows; both operands are staged into
// shared memory as bf16, K-contiguous (As[m][k], Bs[n][k], rows padded to
// 40 values so the fragment reads hit 32 distinct banks). Each of the 8
// warps owns a 32x32 sub-tile and issues 2x4 mma.sync.m16n8k16 (bf16 in,
// fp32 result) per 16 q-rows. Each mma starts from zero, and its 16-product
// sum is added to the running fp32 sum in registers, rounded to nearest.
// Chained through the mma's accumulator operand instead, the tensor core's
// additions, which do not round to nearest, drift over a slab's hundreds
// to thousands of steps: 1-4e-5 of the output's scale on the H100 against
// ~1e-6 this way, for about 1 % more time.
//
// What bounds the bf16 path now is the staging, not the products: every
// element is a 2-byte gather behind its own halo check, through plain loads
// and stores, and the block waits at a barrier for each chunk's gathers
// with nothing to overlap them (no cp.async, ldmatrix, wgmma or TMA yet).
//
// fp32 (off the main path): SIMT FMAs over an 8x4 micro-tile per thread,
// chunks of 16 q-rows staged as fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;
constexpr int kTN = 4;
constexpr int kBK = 16;
constexpr int kAPad = 4;
constexpr int kOutside = -(1 << 28);
// bf16 tensor-core path: q-rows per chunk, and the row padding (in bf16
// values) of the K-contiguous shared tiles: an 80-byte row stride.
constexpr int kMmaBK = 32;
constexpr int kMmaPad = 8;

template <int BN>
__global__ void __launch_bounds__(kThreads)
dw_folded_partial(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, int B, int D, int H, int W,
                  int Cin, int Cout, int K, long long slab_len) {
  constexpr int BM = kThreads * kTM * kTN / BN;  // 256, 128 or 64
  constexpr int TX = BN / kTN;
  constexpr int A_STEP = kThreads / BM;
  constexpr int A_PASSES = kBK / A_STEP;
  constexpr int B_STEP = kThreads / BN;
  constexpr int B_PASSES = kBK / B_STEP;

  __shared__ __align__(16) float As[kBK][BM + kAPad];
  __shared__ __align__(16) float Bs[kBK][BN];
  __shared__ long long s_pos[kBK];  // ((b*D+z)*H+y)*W; -1 past the slab
  __shared__ int s_z[kBK], s_y[kBK], s_u[kBK];

  const int tid = threadIdx.x;
  const int p = (K - 1) / 2;
  const int Wp = W + 2 * p;
  const int rows = K * K * Cin;
  const int cols = K * Cout;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long Q = (long long)B * D * H * Wp;
  const long long q_begin = (long long)blockIdx.z * slab_len;
  const long long q_end = q_begin + slab_len < Q ? q_begin + slab_len : Q;

  // This thread's A row (tz, ty, ci) and Bm column (tx, co).
  const int a_r = tid % BM, a_k0 = tid / BM;
  const int row = r0 + a_r;
  const bool row_ok = row < rows;
  const int ci = row_ok ? row % Cin : 0;
  const int dz = (row_ok ? row / Cin / K : 0) - p;
  const int dy = (row_ok ? row / Cin % K : 0) - p;
  const long long a_off = ((long long)dz * H + dy) * W * Cin + ci;
  const int b_n = tid % BN, b_k0 = tid / BN;
  const int col = n0 + b_n;
  const bool col_ok = col < cols;
  const int tx = col_ok ? col / Cout : 0;
  const int co = col_ok ? col % Cout : 0;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int mx = tid % TX, my = tid / TX;

  for (long long c0 = q_begin; c0 < q_end; c0 += kBK) {
    if (tid < kBK) {
      const long long q = c0 + tid;
      if (q < q_end) {
        long long t = q;
        s_u[tid] = (int)(t % Wp);
        t /= Wp;
        s_y[tid] = (int)(t % H);
        t /= H;
        s_z[tid] = (int)(t % D);
        s_pos[tid] = (q / Wp) * W;
      } else {
        s_u[tid] = s_y[tid] = s_z[tid] = kOutside;
        s_pos[tid] = -1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const int k = a_k0 + i * A_STEP;
      const int zz = s_z[k] + dz, yy = s_y[k] + dy, xx = s_u[k] - p;
      float v = 0.f;
      if (row_ok && (unsigned)zz < (unsigned)D && (unsigned)yy < (unsigned)H &&
          (unsigned)xx < (unsigned)W)
        v = x[(s_pos[k] + xx) * Cin + a_off];
      As[k][a_r] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int k = b_k0 + i * B_STEP;
      const int xx = s_u[k] - tx;
      float v = 0.f;
      if (col_ok && s_pos[k] >= 0 && (unsigned)xx < (unsigned)W)
        v = g[(s_pos[k] + xx) * Cout + co];
      Bs[k][b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][my * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][my * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][mx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // Two barriers per chunk suffice; see conv3d_dw.cu.
  }

  float* out = part + (long long)blockIdx.z * rows * cols;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + my * kTM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + mx * kTN + j;
      if (n < cols) out[(long long)r * cols + n] = acc[i][j];
    }
  }
}

__device__ __forceinline__ unsigned ld_shared_u32(const unsigned short* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d = a * b on the tensor cores, from a zero accumulator: a 16x16 bf16 A
// fragment, a 16x8 bf16 B fragment, a 16x8 fp32 result (PTX ISA layout for
// m16n8k16).
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The bf16 partial product on the tensor cores; x and g are bf16 bits.
// Same tile, slab and halo as dw_folded_partial; each warp owns a 32x32
// sub-tile (8x1 warps for BN=32, 4x2 for 64, 2x4 for 128). A thread stages
// pairs of q-rows of one A row (or Bm column) and stores each pair as one
// 32-bit word, the lower q in the low half, as the fragments want it.
template <int BN>
__global__ void __launch_bounds__(kThreads)
dw_folded_partial_mma(const unsigned short* __restrict__ x,
                      const unsigned short* __restrict__ g,
                      float* __restrict__ part, int B, int D, int H, int W,
                      int Cin, int Cout, int K, long long slab_len) {
  constexpr int BM = kThreads * kTM * kTN / BN;  // 256, 128 or 64
  constexpr int WN = BN / 32;                    // warps across the columns
  constexpr int LD = kMmaBK + kMmaPad;
  constexpr int PAIRS = kMmaBK / 2;
  constexpr int A_STEP = kThreads / BM;
  constexpr int A_PAIRS = PAIRS / A_STEP;
  constexpr int B_STEP = kThreads / BN;
  constexpr int B_PAIRS = PAIRS / B_STEP;

  __shared__ __align__(16) unsigned short As[BM][LD];
  __shared__ __align__(16) unsigned short Bs[BN][LD];
  __shared__ long long s_pos[kMmaBK];  // ((b*D+z)*H+y)*W; -1 past the slab
  __shared__ int s_z[kMmaBK], s_y[kMmaBK], s_u[kMmaBK];

  const int tid = threadIdx.x;
  const int p = (K - 1) / 2;
  const int Wp = W + 2 * p;
  const int rows = K * K * Cin;
  const int cols = K * Cout;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long Q = (long long)B * D * H * Wp;
  const long long q_begin = (long long)blockIdx.z * slab_len;
  const long long q_end = q_begin + slab_len < Q ? q_begin + slab_len : Q;

  // This thread's staged A row (tz, ty, ci) and Bm column (tx, co).
  const int a_r = tid % BM, a_k0 = tid / BM;
  const int row = r0 + a_r;
  const bool row_ok = row < rows;
  const int ci = row_ok ? row % Cin : 0;
  const int dz = (row_ok ? row / Cin / K : 0) - p;
  const int dy = (row_ok ? row / Cin % K : 0) - p;
  const long long a_off = ((long long)dz * H + dy) * W * Cin + ci;
  const int b_n = tid % BN, b_k0 = tid / BN;
  const int col = n0 + b_n;
  const bool col_ok = col < cols;
  const int tx = col_ok ? col / Cout : 0;
  const int co = col_ok ? col % Cout : 0;

  // This thread's place in the fragments: group gq, thread-in-group tq.
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp / WN) * 32, wn = (warp % WN) * 32;
  float acc[2][4][4] = {};

  for (long long c0 = q_begin; c0 < q_end; c0 += kMmaBK) {
    if (tid < kMmaBK) {
      const long long q = c0 + tid;
      if (q < q_end) {
        long long t = q;
        s_u[tid] = (int)(t % Wp);
        t /= Wp;
        s_y[tid] = (int)(t % H);
        t /= H;
        s_z[tid] = (int)(t % D);
        s_pos[tid] = (q / Wp) * W;
      } else {
        s_u[tid] = s_y[tid] = s_z[tid] = kOutside;
        s_pos[tid] = -1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < A_PAIRS; ++i) {
      const int k = 2 * (a_k0 + i * A_STEP);
      unsigned v[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int zz = s_z[k + j] + dz, yy = s_y[k + j] + dy;
        const int xx = s_u[k + j] - p;
        if (row_ok && (unsigned)zz < (unsigned)D &&
            (unsigned)yy < (unsigned)H && (unsigned)xx < (unsigned)W)
          v[j] = x[(s_pos[k + j] + xx) * Cin + a_off];
      }
      *reinterpret_cast<unsigned*>(&As[a_r][k]) = v[0] | (v[1] << 16);
    }
#pragma unroll
    for (int i = 0; i < B_PAIRS; ++i) {
      const int k = 2 * (b_k0 + i * B_STEP);
      unsigned v[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int xx = s_u[k + j] - tx;
        if (col_ok && s_pos[k + j] >= 0 && (unsigned)xx < (unsigned)W)
          v[j] = g[(s_pos[k + j] + xx) * Cout + co];
      }
      *reinterpret_cast<unsigned*>(&Bs[b_n][k]) = v[0] | (v[1] << 16);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const unsigned short* s0 = &As[wm + mi * 16 + gq][ks + 2 * tq];
        a[mi][0] = ld_shared_u32(s0);               // m = g,   k = 2t, 2t+1
        a[mi][1] = ld_shared_u32(s0 + 8 * LD);      // m = g+8
        a[mi][2] = ld_shared_u32(s0 + 8);           // m = g,   k = 2t+8, 2t+9
        a[mi][3] = ld_shared_u32(s0 + 8 * LD + 8);  // m = g+8
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned short* s0 = &Bs[wn + ni * 8 + gq][ks + 2 * tq];
        b[ni][0] = ld_shared_u32(s0);      // n = g, k = 2t, 2t+1
        b[ni][1] = ld_shared_u32(s0 + 8);  // n = g, k = 2t+8, 2t+9
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float d[4];
          mma_bf16_m16n8k16(d, a[mi], b[ni]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
        }
    }
    // Two barriers per chunk suffice; see conv3d_dw.cu.
  }

  // acc[mi][ni][2h+e] is (m = g + 8h, n = 2t + e) of the 16x8 tile (mi, ni).
  float* out = part + (long long)blockIdx.z * rows * cols;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + mi * 16 + gq + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + ni * 8 + 2 * tq + e;
          if (n < cols) out[(long long)r * cols + n] = acc[mi][ni][2 * h + e];
        }
    }
}

// dW[tz,ty,tx,ci,co] = sum over s = 0..S-1, in that order, of
// part[s][(tz*K+ty)*Cin+ci][tx*Cout+co].
__global__ void __launch_bounds__(kThreads)
sum_unfold(const float* __restrict__ part, float* __restrict__ out, int K,
           int Cin, int Cout, int S) {
  const long long n = (long long)K * K * K * Cin * Cout;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long t = i;
  const int co = (int)(t % Cout);
  t /= Cout;
  const int ci = (int)(t % Cin);
  t /= Cin;
  const int tx = (int)(t % K);
  const int tzy = (int)(t / K);  // tz*K + ty
  const long long src = ((long long)tzy * Cin + ci) * K * Cout + tx * Cout + co;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldg(part + (long long)k * n + src);
  out[i] = s;
}

template <typename T, int BN>
void launch_partial(const void* x, const void* g, float* part, int B, int D,
                    int H, int W, int Cin, int Cout, int K, int S,
                    long long slab_len, cudaStream_t stream) {
  constexpr int BM = kThreads * kTM * kTN / BN;
  const int rows = K * K * Cin, cols = K * Cout;
  const dim3 grid((unsigned)((rows + BM - 1) / BM),
                  (unsigned)((cols + BN - 1) / BN), (unsigned)S);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    dw_folded_partial_mma<BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned short*>(x),
        static_cast<const unsigned short*>(g), part, B, D, H, W, Cin, Cout, K,
        slab_len);
  else
    dw_folded_partial<BN><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), part, B, D,
        H, W, Cin, Cout, K, slab_len);
}

template <typename T>
int launch_typed(const void* x, const void* g, float* part, int B, int D,
                 int H, int W, int Cin, int Cout, int K, int bn, int S,
                 long long slab_len, cudaStream_t s) {
  if (bn == 32)
    launch_partial<T, 32>(x, g, part, B, D, H, W, Cin, Cout, K, S, slab_len, s);
  else if (bn == 64)
    launch_partial<T, 64>(x, g, part, B, D, H, W, Cin, Cout, K, S, slab_len, s);
  else if (bn == 128)
    launch_partial<T, 128>(x, g, part, B, D, H, W, Cin, Cout, K, S, slab_len, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes. x and g are bf16 when `is_bf16` is 1, fp32
// when 0. `part` is caller-allocated scratch of S * K^3 * Cin * Cout
// floats; slab s covers q-rows [s*slab_len, min((s+1)*slab_len,
// B*D*H*(W+K-1))). `bn` (32, 64 or 128) is the column tile the caller
// planned S with; the caller cuts slabs on the chunk depth (32 q-rows for
// bf16, 16 for fp32). Launches the partial kernel, then the slab sum, on
// `stream`; does not synchronise, allocates nothing; returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int conv_dw_folded(const void* x, const void* g, float* part,
                              float* out, int is_bf16, int B, int D, int H,
                              int W, int Cin, int Cout, int K, int bn, int S,
                              long long slab_len, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || K < 1 ||
      K % 2 == 0 || S < 1 || S > 65535 || slab_len < 1 ||
      (long long)(S - 1) * slab_len >= (long long)B * D * H * (W + K - 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      is_bf16 ? launch_typed<__nv_bfloat16>(x, g, part, B, D, H, W, Cin, Cout,
                                            K, bn, S, slab_len, s)
              : launch_typed<float>(x, g, part, B, D, H, W, Cin, Cout, K, bn,
                                    S, slab_len, s);
  if (err != 0) return err;
  const long long n = (long long)K * K * K * Cin * Cout;
  sum_unfold<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, out, K, Cin, Cout, S);
  return (int)cudaGetLastError();
}
