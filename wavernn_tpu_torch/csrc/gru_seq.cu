// GRU training recurrence for Hopper (sm_90a): forward and backward, each
// one cooperative persistent launch over all T steps.
//
// Replaces: wavernn_tpu/ops/pallas_gru.py, _make_fwd_kernel (:57, called at
// :102) and _make_bwd_kernel (:122, called at :195), the two TPU kernels
// behind the custom VJP gru_seq_tm. ops/cuda_gru.py holds the wrapper, the
// torch.autograd.Function and the plain versions (gru_seq_ref,
// gru_seq_bwd_ref).
//
// What it computes (torch gate order [r, z, n], time-major streams):
//   forward, per step t:  gh = h @ wh + bh            (f32 accumulation)
//     r = sig(gi_r + gh_r), z = sig(gi_z + gh_z), n = tanh(gi_n + r * gh_n)
//     h' = (1 - z) n + z h;  ys[t] = h',  sv[t] = [r | z | n | gh_n]
//     h is rounded to the stream type every step (ys[t] IS the carry).
//   backward, per reverse step t (dh carried in f32):
//     dtot = dh + dys[t];  dz = dtot (h_{t-1} - n);  dn = dtot (1 - z)
//     dpre_n = dn (1 - n^2);  dhn = dpre_n r;  dpre_r = dpre_n gh_n r (1 - r)
//     dpre_z = dz z (1 - z)
//     dgi[t] = [dpre_r | dpre_z | dpre_n],  dgh[t] = [dpre_r | dpre_z | dhn]
//     dh = dtot z + dgh[t] @ wh^T   (dgh read back in the stream type)
//   The weight gradients (dwh = h_prev^T dgh, dbh = sum dgh) stay outside,
//   as one large matrix product each.
//
// What bounds it on this card. One launch at the WaveRNN training shapes
// (T = 1375, B = 32, H = 512):
//   forward:  69.2 GFLOP (2 T B H 3H), 1.03 ms at 67 TF/s in float32; about
//             0.72 GB moved (gi 270 MB, ys 90 MB, sv 360 MB), 0.215 ms at
//             3.35 TB/s.
//   backward: 69.2 GFLOP, 1.03 ms; about 1.08 GB moved (sv, ys, dys in; dgi,
//             dgh out), 0.32 ms.
// The true limit is the chain of 1375 dependent steps: each needs the whole
// h_{t-1} (forward) or the whole dgh[t] row (backward) of the step before,
// so every step pays a grid-wide barrier and a round trip through L2.
//
// Design, for that chain:
//   * one cooperative launch per direction; blocks stay resident for all T
//     steps and meet at ONE grid.sync() per step;
//   * each block owns U consecutive hidden units with all three gates, so
//     the gate arithmetic stays inside the block; U is the smallest of
//     1, 2, 4, 8 that puts the ceil(H / U) blocks on the SMs (H = 512 on
//     132 SMs: U = 4, 128 blocks); a partial last block is masked;
//   * the block's weights are loaded into shared memory once for all T:
//     forward the 3U columns of wh (H x 3U), backward the U rows of wh
//     (U x 3H, the rows of wh^T it needs), 24 KB each at H = 512 in f32;
//   * forward: each step stages h_{t-1} (= ys[t-1], or h0) through L2
//     (__ldcg, L1 is not coherent across SMs) into shared memory in batch
//     tiles, so shared memory limits no batch size; the staging issues
//     16-byte loads, eight in flight per thread, and each thread's gi loads
//     go out before it, so their latency hides behind it; threads own
//     (row, unit) pairs and split the reduction when pairs are few;
//   * backward: the gate gradients are elementwise and local to the block,
//     their inputs (sv, h_{t-1}, dys) loaded one step ahead; after the
//     barrier each warp takes four batch rows, lanes stride the 3H columns
//     of dgh[t] with 16-byte loads through L2 (twelve in flight per lane),
//     and the U dot products per row reduce with warp shuffles. The f32 dh
//     carry lives in the dh0 output buffer, each block touching only its
//     own units.
// Shapes whose rows are not 16-byte multiples take scalar loads instead.
// Not yet used: tensor cores (mma/wgmma) for the step products, TMA,
// clusters sharing the staged rows. PERF.md has the measured time per step.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;                  // batch rows per warp, backward dot
constexpr size_t SMEM_BUDGET = 200 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// loads of values other blocks wrote during this launch: through L2
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// 16-byte vectors of the stream type: 4 floats or 8 bf16
template <typename S> struct Vec16 { static constexpr int N = 16 / sizeof(S); };

__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace

// Mirrored field for field by ops/cuda_gru.py (ctypes): 8-byte fields only.
struct GruFwdArgs {
  const void* gi;   // (T, B, 3H) S
  const void* wh;   // (H, 3H)    S
  const float* bh;  // (3H,)      f32
  const void* h0;   // (B, H)     S
  void* ys;         // (T, B, H)  S
  void* sv;         // (T, B, 4H) S
  int64_t T, B, H, bf16;
};

struct GruBwdArgs {
  const void* sv;   // (T, B, 4H) S
  const void* ys;   // (T, B, H)  S
  const void* dys;  // (T, B, H)  S
  const void* wh;   // (H, 3H)    S
  const void* h0;   // (B, H)     S
  void* dgi;        // (T, B, 3H) S
  void* dgh;        // (T, B, 3H) S
  float* dh;        // (B, H) f32: zeros in (dh_T), dh0 out (the carry)
  float* dtz;       // (B, H) f32 scratch: dtot * z
  int64_t T, B, H, bf16;
};

namespace {

// shared-memory floats of the forward: weights (K4, U, 4), h tile
// (bt, K4 + 4), partial sums 3 * max(THREADS, bt * U)
__host__ __device__ inline int64_t fwd_k4(int64_t H) { return (H + 3) / 4 * 4; }
__host__ __device__ inline int64_t fwd_w_floats(int64_t H, int U) { return fwd_k4(H) * U * 4; }
__host__ __device__ inline int64_t fwd_red_floats(int64_t bt, int U) {
  const int64_t p = bt * U;
  return 3 * (p > THREADS ? p : THREADS);
}
inline size_t fwd_smem(int64_t H, int U, int64_t bt) {
  return (size_t)(fwd_w_floats(H, U) + bt * (fwd_k4(H) + 4) + fwd_red_floats(bt, U))
         * sizeof(float);
}
inline size_t bwd_smem(int64_t H, int U) { return (size_t)(3 * H * U) * sizeof(float); }

template <typename S, int U>
__global__ void __launch_bounds__(THREADS) gru_fwd(GruFwdArgs a, int bt) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = (int)a.T, B = (int)a.B, H = (int)a.H;
  const int K4 = (int)fwd_k4(H), HP = K4 + 4;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  float* w_s = smem;                           // (K4, U, 4): [r, z, n, 0]
  float* h_s = w_s + fwd_w_floats(H, U);       // (bt, HP)
  float* red = h_s + (size_t)bt * HP;          // partial sums
  const int tid = threadIdx.x;
  const S* gi = (const S*)a.gi;
  const S* wh = (const S*)a.wh;
  const S* h0 = (const S*)a.h0;
  S* ys = (S*)a.ys;
  S* sv = (S*)a.sv;

  for (int e = tid; e < K4 * U; e += THREADS) {
    const int k = e / U, u = e % U;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < H && u < nu) {
      const S* row = wh + (size_t)k * 3 * H + u0 + u;
      w.x = to_f(row[0]);
      w.y = to_f(row[H]);
      w.z = to_f(row[2 * H]);
    }
    reinterpret_cast<float4*>(w_s)[e] = w;
  }

  for (int t = 0; t < T; ++t) {
    const S* hsrc = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      const int P = nb * U;
      // this thread's first (row, unit) pair: its gi loads go out now and
      // land while h is staged and multiplied
      float pg[3] = {0.f, 0.f, 0.f};
      if (tid < P && tid % U < nu) {
        const S* g = gi + ((size_t)t * B + b0 + tid / U) * 3 * H + u0 + tid % U;
        pg[0] = to_f(g[0]);
        pg[1] = to_f(g[H]);
        pg[2] = to_f(g[2 * H]);
      }
      __syncthreads();  // h_s and red free again
      const S* hrows = hsrc + (size_t)b0 * H;
      constexpr int V = Vec16<S>::N;
      if (H % V == 0 && aligned16(hrows)) {
        // 16-byte loads through L2, LOADS of them in flight per thread
        constexpr int LOADS = 8;
        const int nv = H / V, total = nb * nv;
        const uint4* src = reinterpret_cast<const uint4*>(hrows);
        for (int e0 = tid; e0 < total; e0 += THREADS * LOADS) {
          uint4 v[LOADS];
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int e = e0 + i * THREADS;
            if (e < total) v[i] = __ldcg(src + e);
          }
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int e = e0 + i * THREADS;
            if (e < total) {
              float f[V];
              unpack16(v[i], f);
              float* d = h_s + (e / nv) * HP + (e % nv) * V;
#pragma unroll
              for (int q = 0; q < V; ++q) d[q] = f[q];
            }
          }
        }
      } else {
        for (int e = tid; e < nb * K4; e += THREADS) {
          const int b = e / K4, k = e % K4;
          h_s[b * HP + k] = k < H ? ld_cg(hrows + (size_t)b * H + k) : 0.f;
        }
      }
      __syncthreads();
      // (row, unit) pairs, the reduction split KS ways when pairs are few
      const int KS = P >= THREADS ? 1 : THREADS / P;
      const int kc = (K4 / 4 + KS - 1) / KS * 4;
      for (int task = tid; task < P * KS; task += THREADS) {
        const int p = task % P, ks = task / P;
        const int b = p / U, u = p % U;
        const int k0 = ks * kc, k1 = min(K4, k0 + kc);
        float ar = 0.f, az = 0.f, an = 0.f;
        const float* hrow = h_s + b * HP;
        for (int k = k0; k < k1; k += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + k);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = reinterpret_cast<const float4*>(w_s)[(k + i) * U + u];
            ar = fmaf(hk[i], w.x, ar);
            az = fmaf(hk[i], w.y, az);
            an = fmaf(hk[i], w.z, an);
          }
        }
        float* r = red + 3 * ((size_t)ks * P + p);
        r[0] = ar;
        r[1] = az;
        r[2] = an;
      }
      __syncthreads();
      for (int p = tid; p < P; p += THREADS) {
        const int b = p / U, u = p % U;
        if (u >= nu) continue;
        float ar = 0.f, az = 0.f, an = 0.f;
        for (int ks = 0; ks < KS; ++ks) {
          const float* r = red + 3 * ((size_t)ks * P + p);
          ar += r[0];
          az += r[1];
          an += r[2];
        }
        const int j = u0 + u;
        const size_t row = (size_t)t * B + b0 + b;
        float gr = pg[0], gz = pg[1], gn = pg[2];
        if (p != tid) {
          const S* g = gi + row * 3 * H;
          gr = to_f(g[j]);
          gz = to_f(g[H + j]);
          gn = to_f(g[2 * H + j]);
        }
        const float hr = ar + a.bh[j], hz = az + a.bh[H + j], hn = an + a.bh[2 * H + j];
        const float r = sigmoidf(gr + hr);
        const float z = sigmoidf(gz + hz);
        const float n = tanhf(gn + r * hn);
        const float h = (1.f - z) * n + z * h_s[b * HP + j];
        ys[row * H + j] = from_f<S>(h);
        S* s = sv + row * 4 * H;
        s[j] = from_f<S>(r);
        s[H + j] = from_f<S>(z);
        s[2 * H + j] = from_f<S>(n);
        s[3 * H + j] = from_f<S>(hn);
      }
    }
    grid.sync();  // ys[t] complete before any block stages it
  }
}

// The backward's per-(row, unit) inputs of step t: [r, z, n, hn] from sv,
// h_{t-1} (ys[t-1], or h0 at t = 0) and dys[t]. All were written before
// this launch, so plain loads.
struct GateIn {
  float r, z, n, hn, hp, dy;
};

template <typename S>
__device__ __forceinline__ GateIn load_gate(const GruBwdArgs& a, int t, int b, int j) {
  const int B = (int)a.B, H = (int)a.H;
  const size_t row = (size_t)t * B + b;
  const S* s = (const S*)a.sv + row * 4 * H;
  GateIn g;
  g.r = to_f(s[j]);
  g.z = to_f(s[H + j]);
  g.n = to_f(s[2 * H + j]);
  g.hn = to_f(s[3 * H + j]);
  g.hp = t > 0 ? to_f(((const S*)a.ys)[(row - B) * H + j])
               : to_f(((const S*)a.h0)[(size_t)b * H + j]);
  g.dy = to_f(((const S*)a.dys)[row * H + j]);
  return g;
}

template <typename S, int U>
__global__ void __launch_bounds__(THREADS) gru_bwd(GruBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = (int)a.T, B = (int)a.B, H = (int)a.H, G = 3 * H;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  float* w_s = smem;  // (3H, U): w_s[c * U + u] = wh[u0 + u][c]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const S* wh = (const S*)a.wh;
  S* dgi = (S*)a.dgi;
  S* dgh = (S*)a.dgh;

  for (int e = tid; e < G * U; e += THREADS) {
    const int c = e / U, u = e % U;
    w_s[e] = u < nu ? to_f(wh[(size_t)(u0 + u) * G + c]) : 0.f;
  }
  __syncthreads();

  // the gate inputs of this thread's first (row, unit) pair are loaded one
  // step ahead, while the step before runs its dh product
  GateIn pre = {};
  const bool mine = tid < B * U && tid % U < nu;
  if (mine) pre = load_gate<S>(a, T - 1, tid / U, u0 + tid % U);

  for (int t = T - 1; t >= 0; --t) {
    // gate gradients of the block's units: elementwise, no neighbours
    for (int p = tid; p < B * U; p += THREADS) {
      const int b = p / U, u = p % U;
      if (u >= nu) continue;
      const int j = u0 + u;
      const size_t row = (size_t)t * B + b;
      const GateIn g = p == tid ? pre : load_gate<S>(a, t, b, j);
      const float dtot = ld_cg(a.dh + (size_t)b * H + j) + g.dy;
      const float dz = dtot * (g.hp - g.n);
      const float dn = dtot * (1.f - g.z);
      const float dpre_n = dn * (1.f - g.n * g.n);
      const float dhn = dpre_n * g.r;
      const float dpre_r = (dpre_n * g.hn) * g.r * (1.f - g.r);
      const float dpre_z = dz * g.z * (1.f - g.z);
      S* gi_row = dgi + row * G;
      S* gh_row = dgh + row * G;
      gi_row[j] = from_f<S>(dpre_r);
      gi_row[H + j] = from_f<S>(dpre_z);
      gi_row[2 * H + j] = from_f<S>(dpre_n);
      gh_row[j] = from_f<S>(dpre_r);
      gh_row[H + j] = from_f<S>(dpre_z);
      gh_row[2 * H + j] = from_f<S>(dhn);
      a.dtz[(size_t)b * H + j] = dtot * g.z;
    }
    grid.sync();  // dgh[t] complete in every block
    if (mine && t > 0) pre = load_gate<S>(a, t - 1, tid / U, u0 + tid % U);
    // dh = dtot z + dgh[t] @ wh[units, :]^T, ROWS batch rows per warp
    const S* gh_t = dgh + (size_t)t * B * G;
    constexpr int V = Vec16<S>::N;
    const bool vec = G % V == 0 && aligned16(gh_t);
    for (int b0 = warp * ROWS; b0 < B; b0 += WARPS * ROWS) {
      float acc[ROWS][U];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
      if (vec) {
        // 16-byte loads through L2: ROWS x IT of them in flight per lane
        constexpr int IT = 3;
        const int nv = G / V;
        for (int v0 = lane; v0 < nv; v0 += 32 * IT) {
          uint4 raw[IT][ROWS];
#pragma unroll
          for (int it = 0; it < IT; ++it)
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
              const int v = v0 + it * 32;
              raw[it][i] = make_uint4(0u, 0u, 0u, 0u);
              if (v < nv && b0 + i < B)
                raw[it][i] = __ldcg(reinterpret_cast<const uint4*>(
                                        gh_t + (size_t)(b0 + i) * G) + v);
            }
#pragma unroll
          for (int it = 0; it < IT; ++it) {
            const int v = v0 + it * 32;
            if (v >= nv) break;
            float g[ROWS][V];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) unpack16(raw[it][i], g[i]);
#pragma unroll
            for (int q = 0; q < V; ++q) {
              const float* wc = w_s + (size_t)(v * V + q) * U;
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const float w = wc[u];
#pragma unroll
                for (int i = 0; i < ROWS; ++i) acc[i][u] = fmaf(g[i][q], w, acc[i][u]);
              }
            }
          }
        }
      } else {
        for (int c = lane; c < G; c += 32) {
          float w[U];
#pragma unroll
          for (int u = 0; u < U; ++u) w[u] = w_s[c * U + u];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            if (b0 + i < B) {
              const float g = ld_cg(gh_t + (size_t)(b0 + i) * G + c);
#pragma unroll
              for (int u = 0; u < U; ++u) acc[i][u] = fmaf(g, w[u], acc[i][u]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (b0 + i >= B) continue;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float s = warp_sum(acc[i][u]);
          if (lane == u && u < nu) {
            const size_t o = (size_t)(b0 + i) * H + u0 + u;
            a.dh[o] = ld_cg(a.dtz + o) + s;
          }
        }
      }
    }
    __syncthreads();  // this block's dh before its next gate step
  }
}

struct Plan {
  int U;
  int blocks;
  int bt;       // forward batch tile
  size_t smem;
  const void* fn;
};

template <typename S>
const void* fwd_fn(int U) {
  switch (U) {
    case 1: return (const void*)gru_fwd<S, 1>;
    case 2: return (const void*)gru_fwd<S, 2>;
    case 4: return (const void*)gru_fwd<S, 4>;
    default: return (const void*)gru_fwd<S, 8>;
  }
}

template <typename S>
const void* bwd_fn(int U) {
  switch (U) {
    case 1: return (const void*)gru_bwd<S, 1>;
    case 2: return (const void*)gru_bwd<S, 2>;
    case 4: return (const void*)gru_bwd<S, 4>;
    default: return (const void*)gru_bwd<S, 8>;
  }
}

// The launch: the smallest U whose ceil(H / U) blocks fit one per SM (or,
// failing that, fit co-resident at all), with its shared memory.
cudaError_t make_plan(int64_t B, int64_t H, bool bf16, bool backward, Plan* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int us[4] = {1, 2, 4, 8};
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 4; ++i) {
      Plan p;
      p.U = us[i];
      p.blocks = (int)((H + p.U - 1) / p.U);
      if (pass == 0 && p.blocks > sms) continue;
      if (backward) {
        p.bt = 0;
        p.smem = bwd_smem(H, p.U);
        p.fn = bf16 ? bwd_fn<__nv_bfloat16>(p.U) : bwd_fn<float>(p.U);
      } else {
        int64_t bt = B < 64 ? B : 64;
        while (bt > 1 && fwd_smem(H, p.U, bt) > SMEM_BUDGET) bt = (bt + 1) / 2;
        p.bt = (int)bt;
        p.smem = fwd_smem(H, p.U, bt);
        p.fn = bf16 ? fwd_fn<__nv_bfloat16>(p.U) : fwd_fn<float>(p.U);
      }
      if (p.smem > 227 * 1024) continue;
      e = cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
      if (e != cudaSuccess) return e;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, THREADS, p.smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1 || p.blocks > per_sm * sms) continue;
      *out = p;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// The launch plan for these shapes: out = {U, blocks, forward batch tile,
// shared bytes}. Returns the CUDA error code (0 = a plan exists).
int wr_gru_plan(int64_t B, int64_t H, int64_t bf16, int64_t backward, int64_t* out) {
  Plan p;
  const cudaError_t e = make_plan(B, H, bf16 != 0, backward != 0, &p);
  if (e != cudaSuccess) return e;
  out[0] = p.U;
  out[1] = p.blocks;
  out[2] = p.bt;
  out[3] = (int64_t)p.smem;
  return 0;
}

// Forward over all T steps on `stream`; returns the CUDA error code.
int wr_gru_fwd(const GruFwdArgs* args, void* stream) {
  Plan p;
  cudaError_t e = make_plan(args->B, args->H, args->bf16 != 0, false, &p);
  if (e != cudaSuccess) return e;
  GruFwdArgs a = *args;
  int bt = p.bt;  // batch rows per shared-memory tile of h
  void* kargs[] = {&a, &bt};
  e = cudaLaunchCooperativeKernel(p.fn, dim3(p.blocks), dim3(THREADS), kargs, p.smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Backward over all T steps, in reverse, on `stream`; returns the CUDA
// error code. args->dh holds dh_T on entry and dh0 on exit.
int wr_gru_bwd(const GruBwdArgs* args, void* stream) {
  Plan p;
  cudaError_t e = make_plan(args->B, args->H, args->bf16 != 0, true, &p);
  if (e != cudaSuccess) return e;
  GruBwdArgs a = *args;
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(p.fn, dim3(p.blocks), dim3(THREADS), kargs, p.smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
