// WaveRNN sample loop for Hopper (sm_90a), redesigned around the card: the
// weights stay in shared memory for the whole launch, each stage reads the
// previous stage's outputs as step-tagged words instead of behind a grid
// barrier, the conditioning is built once per row, and each warp batches
// its rows. One cooperative launch, one block per SM, generates every row.
// Every serving path's sample loop runs here; csrc/sample_loop_fused.cu is
// the yardstick each arm is held to bit for bit.
//
// Replaces:
//   ARM_FUSED        (B1): wavernn_tpu/ops/pallas_gen.py, _make_fused_kernel
//                    (called through generate_pallas_fused), the sample loop
//                    that upsamples its own conditioning from frame-rate
//                    folded rows;
//   ARM_FUSED, STATE (B4b): the same maker with with_state=True (through
//                    generate_pallas_fused_with_state), resuming from and
//                    snapshotting (h1, h2, x);
//   ARM_MAT, STATE   (B3 with B4a): pallas_gen.py, _make_kernel (with_state
//                    False and True, through generate_pallas and
//                    generate_pallas_with_state), the loop on sample-rate
//                    conditioning rows;
//   SP               (B9): pallas_gen.py, _sparse_mm inside both makers
//                    (through generate_pallas_sparse; packing in
//                    pack_sparse), the block-sparse product of a pruned
//                    model's six per-step matrices: the sparse arm of B1
//                    and of B3 / B4a;
//   ARM_V2           (B10): wavernn_tpu/ops/pallas_gen2.py, _make_kernel
//                    (through generate_pallas_v2), the loop on five
//                    conditioning streams pre-projected into gate space.
//
// What it computes is sample_loop_fused.cu's arms, bit for bit (its head
// note has the equations): every sum keeps that kernel's order.
//
// What bounds it: the latency of a dependent chain, not bytes or FLOPs.
// A step is five stages (gru1 | gru2 | fc1 | fc2 | fc3 + sample), each of
// which needs the whole previous stage from every block, and every step
// needs the previous sample. Counted once, the work is ~1 % of what the
// card could do in that time (PERF.md §6). At 10 rows and more
// the floor becomes L2 bandwidth: every SM reads every stage's whole
// activation vectors.
//
// Design, against the four costs of the original body:
//  1. Weights resident. Block g owns the output units g, g + G, ... of
//     every stage (ops/cuda_gen.resident_plan; 3 or 4 of 512 on 132 SMs)
//     and copies their rows of wi1, wh1, wi2x, wh2, w1x, w2x, and fc3 where
//     it samples, into shared memory once, by cp.async.bulk on an mbarrier;
//     the conditioning matrices' rows of its units too. No step reads a
//     weight from L2. Its per-row state (hidden sums, owned h, the
//     conditioning planes) sits beside them, or, where many rows would
//     crowd out the activation tiles, in its slice of a device buffer.
//  2. Activations as tagged words. Each value a stage writes is stored with
//     its step in one 8-byte word (value bits | step + 1 << 32, single-copy
//     atomic; relaxed gpu-scope stores and loads), in one of two buffers by
//     step parity. A reader polls the rows it needs with 16-byte loads (two
//     such words, each atomic), all in flight at once, and
//     re-polls only the words whose tag is not yet the step's; the data's
//     arrival is the synchronisation. No grid barrier, no fence: a first
//     version with bulk copies of untagged rows behind a red.release /
//     ld.acquire counter barrier spent most of each stage in the arrive,
//     the copy and the wait (PERF.md §6). Two buffers suffice: a
//     writer of step t + 2 needs the sample of step t + 1, hence every
//     block past its reads of step t.
//  3. Conditioning once per row. The block that samples row b builds row
//     b's stage-1 input for the next step, v = base + x*w_Ix (+ phi_j*p_j,
//     j = 0..K-1, in pallas_gen.py:778-781's order), right after it draws
//     x (base, the p_j and w_Ix loaded into shared memory before the draw),
//     and stores it tagged. The conditioning is computed ahead,
//     double-buffered, its dots batched 8 rows to a warp: its global part
//     (B1's mel taps p_j and base, B3's base: the samplers read them,
//     tagged) and its local part (gi2a, f1a, f2a: only their owner reads
//     them, from shared memory), after stage 1: B1's next chunk at a
//     chunk's first step; B3's next step's local part and the step
//     after's global part (its rows copied into shared memory once).
//  4. Off the critical path, and batched. W_h1 h1 and W_h2 h2 for the next
//     step run into their own sums, as warp_dots kept them: after stages
//     2 and 3, or, where the plan leaves the sampling blocks no unit (few
//     rows: `exclusive`), in the other blocks during stage 5, while the
//     rows are sampled (PERF.md §6 has what it saves). A warp takes one
//     unit and up to 8 rows, every lane sums its chunks for all of them,
//     and a recursive-halving exchange (the butterfly's pairs at every
//     level, so the same bits) leaves the sums spread over the lanes: the
//     gate tails then run one lane per row. With one tile of rows a block
//     forms xr = v + h1 and x2 = xr + h2 itself from h1 and h2, the sums
//     their writers formed, so it reads two vectors fewer a step.
//
// B9, the sparse arm (template flag SP; ops/cuda_gen.resident_sparse_table
// builds its per-block table from the pack). Bound as the dense arm: the
// products are ~1 % of a step, so skipping 15 of 16 blocks' terms alone
// saves little; what a pruned step can shed is the polling. So:
//  - each owned unit row of each per-step matrix carries the mask of its
//    live 8-column chunks (a (128, 128) block is 16 chunks, a legacy
//    (128, 8) block one; a matrix the pack left dense is all live); lane l
//    keeps the dense order (chunks c = l mod 32 in increasing c) and skips
//    the dead ones, and a unit with no live chunk skips its product and
//    exchange: a dead block's terms are exactly +0 in the dense sum, so
//    every output equals the dense arm's on the same masked weights;
//  - a block polls only the chunks its live chunks read (and, with several
//    tiles of rows, its own units' columns for xr and x2), from a list per
//    stage; stage 1 polls at least one chunk of every row;
//  - with readers skipping words, a writer two steps ahead is no longer
//    held back by what it reads, so every acting block stores a tagged
//    done word after its stage-1 poll, and the samplers poll them all
//    before they draw: a writer of step t + 2 has seen every row's input
//    of step t + 2, hence every sampler past every block's done word of
//    step t + 1, hence every block past its reads of step t.
// The weights stay dense in shared memory (the dead chunks' zeros too).
//
// B10, the pre-projected arm (ARM_V2). Its stage 1 has no product of the
// stage-1 input (gi1 = stream gi1[t] + x*wxw1), and W_h1 h1 is already a
// deferred sum, so stage 1 is gate arithmetic at each unit's owner as soon
// as the row's sample arrives: the samplers store x tagged, each owner
// polls the B samples, forms h1 and stores it tagged; no broadcast of a
// stage-1 input, four broadcast stages a step (h1 | h2, x2 | fc1 | fc2)
// and the samples. x2 = ((i[t] + x*w_Ix) + h1) + h2 at h2's owner. The
// streams do not depend on the recurrence: the wrapper gathers them once
// per launch into the plan's unit order, a (T, G, slice) float32 array
// (ops/cuda_gen2.py), and each block bulk-copies its step t + 1 slice
// into shared memory during step t (two slots on mbarriers), or, where
// many rows put the per-row regions in device memory, reads its slice
// there after an L2 prefetch one step ahead.
//
// Exactness: lane l sums the 8-column chunks c = l (mod 32) of a row in
// increasing c, each in element order, then the xor butterfly's pairs;
// scalar conditioning dots take columns k = l (mod 32) in order, then the
// butterfly's pairs; the gate, fc and sampling expressions are the original
// body's. A product read from shared memory gives the bits it gave from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LOG_SCALE_MIN = -32.23619130191664f;  // log(1e-14)
constexpr float MOL_U_SCALE = (float)(1.0 - 2e-5);
constexpr int GRU_ROWS = 8;  // rows a warp batches in a GRU stage: 3 x 8 sums
constexpr int FC_ROWS = 8;   // rows a warp batches in fc1 / fc2
constexpr int KMAX = 8;       // mel taps a sampler preloads
constexpr unsigned SPIN_LIMIT = 1u << 24;  // polls before a lost producer traps

constexpr int ARM_FUSED = 0;  // B1, B4b: conditioning from frame-rate folds
constexpr int ARM_MAT = 1;    // B3: sample-rate conditioning rows
constexpr int ARM_V2 = 2;     // B10: pre-projected gate-space streams

// B9's fetch lists (ResArgs::sparse, per block): the chunks each poll reads;
// L_DONE: the samplers' poll of the done words, then a whole row; L_ALL:
// whole rows
enum List { L_V, L_H1, L_XR, L_H2, L_X2, L_HF1, N_LISTS, L_DONE = N_LISTS, L_ALL };
// B9's table header (words): chunk-mask words a row of R and of FC columns,
// list capacity, the word offsets (past the header) of the fc1 masks, the
// fc2 masks, the list lengths and the acting blocks' bitmask, R, FC, and
// (written by the kernel) the done words' address; the R units' masks
// start right after the header, (UR, 4 matrices wi1 wh1 wi2x wh2, 3
// gates, NW_R words)
enum SparseHead {
  H_NWR, H_NWF, H_LMAX, H_F1, H_F2, H_LENS, H_ACT, H_R, H_FC, H_DONE = 10,
  N_HEAD = 16
};
// B9 passes a list or a layer to its helpers in a tag's top bits (a tag is
// a step + 1 < 2^29; the wrapper checks)
constexpr int ID_SHIFT = 29;
constexpr uint32_t TAG_MASK = (1u << ID_SHIFT) - 1;

// Shared-memory regions, byte offsets in ResArgs::off (ops/cuda_gen.py's
// RESIDENT_REGIONS, same order). The per-row ones (S_GH1 .. S_PLANE: the
// hidden sums, the owned units' state, the conditioning planes) are
// private to their block; with many rows the plan puts them in device
// memory instead, at these offsets in the block's slice of ResArgs::rows
enum Region {
  S_MBAR, S_SPARSE, S_PROF, S_WI1, S_WH1, S_WI2X, S_WH2, S_W1X, S_W2X, S_W3, S_WIMEL,
  S_WIA1, S_WI2A, S_W1A, S_W2A, S_GH1, S_GH2, S_OWNH1, S_OWNH2, S_PLANE,
  S_XOWN, S_LOGIT, S_CONST, S_TA, S_TB, S_XALL, N_REGIONS
};
// B9's table sits at this fixed offset, right after the weights' mbarrier
// (the plan checks it), so the helpers find it without a pointer held
// across the step loop
constexpr int SPARSE_OFF = 16;

// per-stage split of a step (the profiling instantiation, block 0, thread 0)
constexpr int N_PSTAGE = 6;  // prologue, stages 1-5
// first poll pass, waiting on producers, products, tails, deferred work, other
constexpr int N_PKIND = 6;

}  // namespace

// Mirrored field for field by ops/cuda_gen.py (ctypes): 8-byte fields only.
struct ResArgs {
  const float* frames;  // B1: (nf_loc, B, C) f32, C = n_mels + 4A
  const float* phi;     // B1: (K, hop) f32
  const float* cond;    // B3: (T, B, C) f32
  const float* noise;   // (T, B, NU) f32 injected uniforms, or null
  const void* w_imel;   // (R, n_mels)   WT
  const void* w_ia1;    // (R, A)        WT
  const float* w_ix;    // (R,)
  const float* b_i;     // (R,)
  const void* wi1;      // (3R, R)       WT
  const void* wh1;      // (3R, R)       WT
  const float* bi1;     // (3R,)
  const float* bh1;     // (3R,)
  const void* wi2x;     // (3R, R)       WT
  const void* wi2a;     // (3R, A)       WT
  const void* wh2;      // (3R, R)       WT
  const float* bi2;     // (3R,)
  const float* bh2;     // (3R,)
  const void* w1x;      // (FC, R)       WT
  const void* w1a;      // (FC, A)       WT
  const float* b1;      // (FC,)
  const void* w2x;      // (FC, FC)      WT
  const void* w2a;      // (FC, A)       WT
  const float* b2;      // (FC,)
  const void* w3;       // (NC, FC)      WT
  const float* b3;      // (NC,)
  const float* h1_0;    // STATE: (B, R) initial state, or null for zeros
  const float* h2_0;    // (B, R)
  const float* x_0;     // (B,)
  float* snap_h1;       // STATE: (B, R) the state entering snapshot_at
  float* snap_h2;       // (B, R)
  float* snap_x;        // (B,)
  float* out;           // (B, T) f32
  float* work;          // zeroed workspace (wr_resident_work_floats)
  const int32_t* units_r;   // (G, UR) the R-wide units each block owns, -1 pad
  const int32_t* units_fc;  // (G, UF) the FC-wide units
  long long* prof;      // profiling: (N_PSTAGE, N_PKIND) cycles, and steps
  float* rows;          // (G, row_bytes / 4) the per-row regions, or null
                        // where they lie in shared memory
  const float* wxw1;    // B10: (3R,) W_i1 w_Ix
  const float* wxw2;    // B10: (3R,) W_i2x w_Ix
  const float* streams; // B10: (T, G, PBV) f32 the streams in unit order
  const int32_t* sparse;  // B9: (G, SW) masks, list lengths, lists
  int64_t B, R, FC, A, n_mels, NC, K, hop, fold_chunks, aux_tap;
  int64_t T, snapshot_at, mol, seed, bf16;
  int64_t G, UR, UF, TR, w3_resident, exclusive, smem_bytes, row_bytes;
  int64_t PBV, SW;      // B10's slice floats a step; B9's table words a block
  int64_t off[N_REGIONS];
};

namespace {

typedef unsigned long long u64;

// ---- loads ----
__device__ __forceinline__ void ld8(const float* p, float (&w)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    w[2 * e] = f.x;
    w[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ---- tagged words: value bits | tag << 32, stored and polled whole ----
__device__ __forceinline__ void st_tagged(u64* p, float v, uint32_t tag) {
  const u64 w = ((u64)tag << 32) | (u64)__float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ void ld_tagged2(const u64* p, u64& a, u64& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b)
               : "l"(p)
               : "memory");
}

__device__ __forceinline__ u64 ld_tagged(const u64* p) {
  u64 a;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(a) : "l"(p) : "memory");
  return a;
}

__device__ __forceinline__ bool has_tag(u64 w, uint32_t tag) {
  return (uint32_t)(w >> 32) == tag;
}

__device__ __forceinline__ float tagged_value(u64 w) {
  return __uint_as_float((uint32_t)w);
}

__device__ __forceinline__ void spin_guard(unsigned& spins) {
  if (++spins > SPIN_LIMIT) __trap();  // a producer that never writes
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NV sums at once (NV = 8 or 32): value q of every lane ends, summed over
// the warp, on lanes q*32/NV .. (q+1)*32/NV - 1. Level o pairs lane l with
// l ^ o and adds own + partner, as the xor butterfly does for every value,
// but while a lane holds more than one value it keeps only half of them
// (the upper half where bit o of l is set): 31 shuffles for 32 sums, not
// 160, and every sum's tree of pairs is the butterfly's, so the bits are.
template <int N>
__device__ __forceinline__ void halve(float* v, int o, bool upper) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float send = upper ? v[q] : v[q + N / 2];
    const float keep = upper ? v[q + N / 2] : v[q];
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV]) {
  static_assert(NV == 8 || NV == 32, "8 or 32 sums");
  const int lane = threadIdx.x & 31;
  if constexpr (NV == 32) {
    halve<32>(v, 16, lane & 16);
    halve<16>(v, 8, lane & 8);
    halve<8>(v, 4, lane & 4);
    halve<4>(v, 2, lane & 2);
    halve<2>(v, 1, lane & 1);
  } else {
    halve<8>(v, 16, lane & 16);
    halve<4>(v, 8, lane & 8);
    halve<2>(v, 4, lane & 4);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  }
  return v[0];
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// NG gate rows of one unit (row g at w + g*gstride, length n, n % 8 == 0)
// against rows 0..nb-1 (nb <= RB) of a tile (row stride n): the sum of
// value q = g*RB + b (0 past the last) lands as reduce_scatter<NV> puts it,
// NV = 8 for NG*RB <= 8, else 32. Each sum in sample_loop_fused.cu's
// warp_dots order.
template <int NG, int RB, typename WT>
__device__ __noinline__ float rows_dots(const WT* w, int gstride,
                                        const float* tile, int n, int nb) {
  constexpr int NV = NG * RB <= 8 ? 8 : 32;
  static_assert(NG * RB <= NV, "at most 32 sums");
  const int lane = threadIdx.x & 31;
  float v[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = 0.f;
  for (int k0 = lane * 8; k0 < n; k0 += 256) {
    float w8[NG][8];
#pragma unroll
    for (int g = 0; g < NG; ++g) ld8(w + (size_t)g * gstride + k0, w8[g]);
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (b < nb) {
        float a[8];
        ld8(tile + (size_t)b * n + k0, a);
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[g * RB + b] = fmaf(w8[g][e], a[e], v[g * RB + b]);
      }
    }
  }
  return reduce_scatter(v);
}

// B9's rows_dots: gate row g's live chunks are the bits of m[g * mg + i]
// (chunk c = 32 i + bit); a lane skips its dead chunks (their terms are +0
// in the dense sum, and the tile's columns there may be stale), in the
// dense order otherwise. One gate row's weights at a time (each sum gets
// the same terms in the same order): fewer registers than rows_dots, which
// the kernel keeps for its calls.
template <int NG, int RB, typename WT>
__device__ __noinline__ float rows_dots_sp(const WT* w, int gstride,
                                           const float* tile, int n, int nb,
                                           const uint32_t* m, int mg) {
  constexpr int NV = NG * RB <= 8 ? 8 : 32;
  static_assert(NG * RB <= NV, "at most 32 sums");
  const int lane = threadIdx.x & 31;
  float v[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = 0.f;
  for (int k0 = lane * 8, i = 0; k0 < n; k0 += 256, ++i) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (!(m[g * mg + i] >> lane & 1u)) continue;
      float w8[8];
      ld8(w + (size_t)g * gstride + k0, w8);
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        if (b < nb) {
          float a[8];
          ld8(tile + (size_t)b * n + k0, a);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[g * RB + b] = fmaf(w8[e], a[e], v[g * RB + b]);
        }
      }
    }
  }
  return reduce_scatter(v);
}

// B9's table in this block's shared memory
__device__ __forceinline__ const uint32_t* sparse_table() {
  extern __shared__ __align__(128) unsigned char smem[];
  return reinterpret_cast<const uint32_t*>(smem + SPARSE_OFF);
}

// B9: whether any of n mask words has a live chunk
__device__ __forceinline__ bool any_live(const uint32_t* m, int n) {
  uint32_t u = 0;
  for (int i = 0; i < n; ++i) u |= m[i];
  return u != 0;
}

// Counter-based uniforms (ops/cuda_gen.counter_uniforms holds the same hash)
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float counter_uniform(uint32_t key, uint32_t ctr,
                                                 bool mol) {
  const float u = __fmul_rn((float)(lowbias32(ctr ^ key) >> 8),
                            5.9604644775390625e-08f);  // 2^-24
  return mol ? __fadd_rn(__fmul_rn(u, MOL_U_SCALE), 1e-5f) : __fadd_rn(u, 1e-9f);
}

// argmax over the warp with the first index winning ties (jnp/torch argmax)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// ---- the weights' one-time bulk copy ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* mb, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(mb)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* mb, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(mb)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mb, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(mb)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, bytes % 16 == 0, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(mb))
      : "memory");
}

// Rows of an (., n) vector of tagged words (count values from src) into
// dst as floats, once every word carries `tag`: each thread keeps up to 8
// 16-byte loads in flight and re-polls only the words not yet tagged. All
// threads; ends with __syncthreads. Returns clock64() at the calling
// thread's first pass (for the profile).
__device__ __noinline__ long long fetch_tagged(float* dst, const u64* src,
                                               int count, uint32_t tag) {
  const int words = count / 2;  // two values a 16-byte load
  long long first = 0;
  __syncthreads();  // every warp is done with dst's previous rows
  for (int w0 = threadIdx.x; w0 < words; w0 += 8 * THREADS) {
    unsigned pending = 0, spins = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (w0 + q * THREADS < words) pending |= 1u << q;
    while (pending) {
      u64 lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (pending >> q & 1) ld_tagged2(src + 2 * (size_t)(w0 + q * THREADS), lo[q], hi[q]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if ((pending >> q & 1) && has_tag(lo[q], tag) && has_tag(hi[q], tag)) {
          reinterpret_cast<float2*>(dst)[w0 + q * THREADS] =
              make_float2(tagged_value(lo[q]), tagged_value(hi[q]));
          pending &= ~(1u << q);
        }
      }
      if (!first) first = clock64();
      if (pending) spin_guard(spins);
    }
  }
  if (!first) first = clock64();
  __syncthreads();
  return first;
}

// B9's fetch_tagged, list l in tagl's top bits: only the 8-column chunks of
// list l of each row of an (., n) vector (n: FC for L_HF1, else R; the
// other columns of dst keep what they held); with an empty list it only
// synchronises. L_V also stores this block's done word for the step (every
// read of the step before is behind it); L_DONE first polls every acting
// block's done word, then fetches the whole count, as L_ALL does. All
// threads. Q loads in flight a thread: the helper's registers are its
// caller's to keep around the call (B1's arm takes four, B3's two).
template <int Q>
__device__ __noinline__ long long fetch_listed(float* dst, const u64* src,
                                               int count, uint32_t tagl) {
  const uint32_t tag = tagl & TAG_MASK;
  const int l = (int)(tagl >> ID_SHIFT);
  const uint32_t* tb = sparse_table();
  u64* done = *reinterpret_cast<u64* const*>(tb + H_DONE) + (size_t)(tag & 1 ? 0 : 1) * gridDim.x;
  if (l == L_DONE) {
    const uint32_t* act = tb + N_HEAD + tb[H_ACT];
    for (int q = threadIdx.x; q < (int)gridDim.x; q += THREADS) {
      if (!(act[q >> 5] >> (q & 31) & 1u)) continue;
      unsigned spins = 0;
      while (!has_tag(ld_tagged(done + q), tag)) spin_guard(spins);
    }
  }
  // whole rows (L_DONE, L_ALL) take load e at word 2e; no call to
  // fetch_tagged, whose registers this helper's caller would keep too
  const bool whole = l >= L_DONE;
  const int n = (int)(l == L_HF1 ? tb[H_FC] : tb[H_R]);
  const int nb = whole ? 1 : count / n;  // whole: one row of count floats
  const int* lens = reinterpret_cast<const int*>(tb + N_HEAD + tb[H_LENS]);
  const uint16_t* list =
      reinterpret_cast<const uint16_t*>(lens + 8) + (whole ? 0 : l) * tb[H_LMAX];
  const int per_row = whole ? count / 2 : lens[l] * 4;  // 16-byte loads a row
  long long first = 0;
  __syncthreads();  // every warp is done with dst's previous rows, and
                    // past its reads of the step before
  if (l == L_V && threadIdx.x == 0) st_tagged(done + blockIdx.x, 0.f, tag);
  // load e = b * per_row + r (row b, slot r: a column pair) is thread e %
  // THREADS's; each thread steps (b, r) on by THREADS loads at a time,
  // without a division, and keeps Q loads in flight
  const int loads = nb * per_row;
  const int db = per_row ? THREADS / per_row : 0, dr = per_row ? THREADS % per_row : 0;
  int b = per_row ? threadIdx.x / per_row : 0, r = per_row ? threadIdx.x % per_row : 0;
  for (int e0 = threadIdx.x; e0 < loads; e0 += Q * THREADS) {
    unsigned pending = 0, spins = 0;
    int off[Q];  // each load's first word
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      off[q] = b * n + (whole ? 2 * r : list[r >> 2] * 8 + (r & 3) * 2);
      if (e0 + q * THREADS < loads) pending |= 1u << q;
      b += db;
      r += dr;
      if (r >= per_row) {
        r -= per_row;
        ++b;
      }
    }
    while (pending) {
      u64 lo[Q], hi[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (pending >> q & 1) ld_tagged2(src + off[q], lo[q], hi[q]);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if ((pending >> q & 1) && has_tag(lo[q], tag) && has_tag(hi[q], tag)) {
          reinterpret_cast<float2*>(dst)[off[q] >> 1] =
              make_float2(tagged_value(lo[q]), tagged_value(hi[q]));
          pending &= ~(1u << q);
        }
      }
      if (!first) first = clock64();
      if (pending) spin_guard(spins);
    }
  }
  if (!first) first = clock64();
  __syncthreads();
  return first;
}

// B10: count single tagged words (the samples) into dst once each carries
// `tag`. All threads, between two __syncthreads.
__device__ __forceinline__ void poll_words(float* dst, const u64* src, int count,
                                           uint32_t tag) {
  __syncthreads();  // every warp is done with dst
  for (int i = threadIdx.x; i < count; i += THREADS) {
    unsigned spins = 0;
    u64 w = ld_tagged(src + i);
    while (!has_tag(w, tag)) {
      spin_guard(spins);
      w = ld_tagged(src + i);
    }
    dst[i] = tagged_value(w);
  }
  __syncthreads();
}

// One conditioning task of a warp: one weight row w (length n <= 128, in
// shared memory) against up to 8 rows x + q*C (q < nb), each dot in
// warp_dot_scalar's order (lane l: columns l, l + 32, ... in order, then
// the butterfly's pairs); dot q lands on lanes 4q .. 4q + 3.
template <typename WT>
__device__ __forceinline__ float cond_dots(const WT* w, const float* x, int n,
                                        int C, int nb) {
  const int lane = threadIdx.x & 31;
  float wl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wl[i] = lane + 32 * i < n ? ld1(w + lane + 32 * i) : 0.f;
  // two rows' loads first, from addresses clamped into the rows (so they
  // need no guard and stay in flight together), then their guarded chains
  float v[8];
#pragma unroll
  for (int q0 = 0; q0 < 8; q0 += 2) {
    float xs[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* xq = x + (size_t)min(q0 + q, nb - 1) * C;
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[q][i] = xq[min(lane + 32 * i, n - 1)];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q0 + q < nb && lane + 32 * i < n) acc = fmaf(wl[i], xs[q][i], acc);
      v[q0 + q] = acc;
    }
  }
  return reduce_scatter(v);
}

// groups a stage splits nb rows into: at most `rb` rows each, and enough
// to give every warp an item where the units are few; group gi's rows are
// [gi*nb/ng, (gi + 1)*nb/ng)
__device__ __forceinline__ int n_groups(int units, int nb, int rb) {
  int ng = (nb + rb - 1) / rb;
  if (units > 0) ng = max(ng, min(nb, WARPS / units));
  return max(ng, 1);
}

// A GRU stage's items over the tile rows [b0, b0 + nb): one owned unit and
// up to GRU_ROWS rows a warp. Row b's gate sums land on lanes t, t + 8,
// t + 16 (t = b; t = 4b for one or two rows, whose shorter exchange has 9
// shuffles) and its tail runs on lane t. mode 0: gru1 (input addends bi1,
// hidden bias bh1), 1: gru2 (input addends gi2a from `ga`, bias bh2); both
// take the hidden sums from gh, update ownh, store h (and x = tile + h
// unless xg is null) tagged; mode 2: W_h h of the state rows in `tile`,
// into gh. One copy of this code serves every GRU stage.
template <typename WT>
__device__ __noinline__ void gru_pass(int mode, const WT* W, const float* tile,
                                      int nb, int b0, int nR, int R, int B,
                                      float* gh, const float* ga,
                                      const float* cr, const int* units,
                                      float* ownh, u64* hg, u64* xg,
                                      uint32_t tag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n_groups(nR, nb, GRU_ROWS);
  for (int it = warp; it < nR * ng; it += WARPS) {
    const int s = it / ng, gi = it % ng;
    const int lo = gi * nb / ng, cnt = (gi + 1) * nb / ng - lo;
    const bool few = cnt <= 2;
    const WT* w = W + (size_t)s * 3 * R;
    const float* rows = tile + (size_t)lo * R;
    const float gr = few ? rows_dots<3, 2>(w, R, rows, R, cnt)
                         : rows_dots<3, GRU_ROWS>(w, R, rows, R, cnt);
    const float gz = __shfl_sync(0xffffffffu, gr, (lane + 8) & 31);
    const float gn = __shfl_sync(0xffffffffu, gr, (lane + 16) & 31);
    const int b = few ? lane >> 2 : lane;
    if ((few && (lane & 3) != 0) || b >= cnt) continue;
    const int bb = b0 + lo + b;
    float* ghs = gh + (size_t)s * 3 * B + bb;
    if (mode == 2) {
      ghs[0] = gr;
      ghs[B] = gz;
      ghs[2 * B] = gn;
      continue;
    }
    const int j = units[s];
    const float hr = ghs[0], hz = ghs[B], hn = ghs[2 * B];
    const float* c = cr + s * 13;  // bi1 r z n, bh1 r z n, bh2 r z n, ...
    float ar, az, an;             // the input side's addends
    if (mode == 0) {
      ar = c[0];
      az = c[1];
      an = c[2];
    } else {
      const float* gas = ga + (size_t)s * 3 * B + bb;  // a2 terms + bi2
      ar = gas[0];
      az = gas[B];
      an = gas[2 * B];
    }
    const float* hb = c + (mode == 0 ? 3 : 6);
    const float r = sigmoidf((gr + ar) + (hr + hb[0]));
    const float z = sigmoidf((gz + az) + (hz + hb[1]));
    const float n = tanhf((gn + an) + r * (hn + hb[2]));
    const float h = (1.f - z) * n + z * ownh[s * B + bb];
    ownh[s * B + bb] = h;
    st_tagged(hg + (size_t)bb * R + j, h, tag);
    if (xg) st_tagged(xg + (size_t)bb * R + j, tile[(size_t)(lo + b) * R + j] + h, tag);
  }
}

// B10's extra operands of gru_pass
struct V2X {
  const float* xs;    // (B,) the samples entering the step
  const float* si;    // the i stream's slice (UR, B)
  const float* own1;  // the owned units' new h1 (UR, B)
};

template <typename T, typename... Rest>
__device__ __forceinline__ T first(T t, Rest...) { return t; }

// the dot products of one unit's NG gate rows: dense, or (SP, unit mask
// words m, nw a row) over the live chunks, +0 where there are none
template <int NG, int RB, typename WT, bool SP>
__device__ __forceinline__ float unit_dots(const WT* w, int gstride,
                                           const float* tile, int n, int nb,
                                           const uint32_t* m, int nw) {
  if constexpr (SP) {
    if (!any_live(m, NG * nw)) return 0.f;
    return rows_dots_sp<NG, RB, WT>(w, gstride, tile, n, nb, m, nw);
  } else {
    return rows_dots<NG, RB, WT>(w, gstride, tile, n, nb);
  }
}

// gru_pass for the arms. SP (B9): mode's bits 2-3 name the matrix mi (0
// wi1, 1 wh1, 2 wi2x, 3 wh2) whose masks the table holds; a unit with no
// live chunk skips its product (all +0). V2 (B10), its extra operand a
// V2X: its gru2 (mode 1) takes the input addends gi2[t] + x wxw2 from the
// stream slice `ga` and the samples, and stores x2 = ((i[t] + x w_Ix) +
// h1) + h2.
template <typename WT, bool SP, bool V2, typename... X>
__device__ __noinline__ void gru_pass_arm(int mode, const WT* W, const float* tile,
                                          int nb, int b0, int nR, int R, int B,
                                          float* gh, const float* ga,
                                          const float* cr, const int* units,
                                          float* ownh, u64* hg, u64* xg,
                                          uint32_t tag, X... x) {
  const int mi = mode >> 2;
  mode &= 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n_groups(nR, nb, GRU_ROWS);
  for (int it = warp; it < nR * ng; it += WARPS) {
    const int s = it / ng, gi = it % ng;
    const int lo = gi * nb / ng, cnt = (gi + 1) * nb / ng - lo;
    const bool few = cnt <= 2;
    const WT* w = W + (size_t)s * 3 * R;
    const float* rows = tile + (size_t)lo * R;
    const uint32_t* m = nullptr;
    int nw = 0;
    if constexpr (SP) {
      const uint32_t* tb = sparse_table();
      nw = (int)tb[H_NWR];
      m = tb + N_HEAD + (s * 4 + mi) * 3 * nw;
    }
    const float gr = few ? unit_dots<3, 2, WT, SP>(w, R, rows, R, cnt, m, nw)
                         : unit_dots<3, GRU_ROWS, WT, SP>(w, R, rows, R, cnt, m, nw);
    const float gz = __shfl_sync(0xffffffffu, gr, (lane + 8) & 31);
    const float gn = __shfl_sync(0xffffffffu, gr, (lane + 16) & 31);
    const int b = few ? lane >> 2 : lane;
    if ((few && (lane & 3) != 0) || b >= cnt) continue;
    const int bb = b0 + lo + b;
    float* ghs = gh + (size_t)s * 3 * B + bb;
    if (mode == 2) {
      ghs[0] = gr;
      ghs[B] = gz;
      ghs[2 * B] = gn;
      continue;
    }
    const int j = units[s];
    const float hr = ghs[0], hz = ghs[B], hn = ghs[2 * B];
    const float* c = cr + s * 13;  // bi1 r z n, bh1 r z n, bh2 r z n, ...
    float ar, az, an;             // the input side's addends
    const float* gas = ga + (size_t)s * 3 * B + bb;  // a2 terms + bi2
    if (mode == 0) {
      ar = c[0];
      az = c[1];
      an = c[2];
    } else if constexpr (V2) {  // (stream + x wxw2), then + the product below
      const float xv = first(x...).xs[bb];
      ar = gas[0] + xv * c[10];
      az = gas[B] + xv * c[11];
      an = gas[2 * B] + xv * c[12];
    } else {
      ar = gas[0];
      az = gas[B];
      an = gas[2 * B];
    }
    const float* hb = c + (mode == 0 ? 3 : 6);
    const float r = sigmoidf((gr + ar) + (hr + hb[0]));
    const float z = sigmoidf((gz + az) + (hz + hb[1]));
    const float n = tanhf((gn + an) + r * (hn + hb[2]));
    const float h = (1.f - z) * n + z * ownh[s * B + bb];
    ownh[s * B + bb] = h;
    st_tagged(hg + (size_t)bb * R + j, h, tag);
    if constexpr (V2) {
      const V2X e = first(x...);
      const float inp = e.si[s * B + bb] + e.xs[bb] * c[9];
      const float xr = inp + e.own1[s * B + bb];
      st_tagged(xg + (size_t)bb * R + j, xr + h, tag);
    } else {
      if (xg) st_tagged(xg + (size_t)bb * R + j, tile[(size_t)(lo + b) * R + j] + h, tag);
    }
  }
}

// B10's stage 1, gate arithmetic only: h1 of every owned unit and row from
// gi1[t] + x wxw1 (the stream slice g1, the samples xs) and the deferred
// hidden sums gh, in the original body's order; updates ownh, stores h1
// tagged. cr: the unit's constants (wxw1 r z n, bh1 r z n, ...).
__device__ __noinline__ void v2_gru1(const float* g1, const float* xs,
                                     const float* gh, const float* cr,
                                     const int* units, float* ownh, u64* hg,
                                     int nR, int R, int B, uint32_t tag) {
  for (int e = threadIdx.x; e < nR * B; e += THREADS) {
    const int s = e / B, b = e - s * B;
    const float x = xs[b];
    const float* c = cr + s * 13;
    const float* gs = g1 + (size_t)s * 3 * B + b;
    const float* ghs = gh + (size_t)s * 3 * B + b;
    const float gr = gs[0] + x * c[0];
    const float gz = gs[B] + x * c[1];
    const float gn = gs[2 * B] + x * c[2];
    const float r = sigmoidf(gr + (ghs[0] + c[3]));
    const float z = sigmoidf(gz + (ghs[B] + c[4]));
    const float n = tanhf(gn + r * (ghs[2 * B] + c[5]));
    const float h = (1.f - z) * n + z * ownh[e];
    ownh[e] = h;
    st_tagged(hg + (size_t)b * R + units[s], h, tag);
  }
}

// fc1 or fc2's items over the tile rows [b0, b0 + nb) (row stride n): one
// owned unit and up to FC_ROWS rows a warp; row b's sum lands on lanes 4b
// .. 4b + 3, and lane 4b stores relu(sum + add) tagged.
template <typename WT>
__device__ __noinline__ void fc_pass(const WT* W, int n, const float* tile,
                                     int nb, int b0, int nF, int FC, int B,
                                     const int* units, const float* add,
                                     u64* dst, uint32_t tag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n_groups(nF, nb, FC_ROWS);
  for (int it = warp; it < nF * ng; it += WARPS) {
    const int s = it / ng, gi = it % ng;
    const int lo = gi * nb / ng, cnt = (gi + 1) * nb / ng - lo;
    const float v = rows_dots<1, FC_ROWS>(W + (size_t)s * n, 0,
                                          tile + (size_t)lo * n, n, cnt);
    const int b = lane >> 2;
    if ((lane & 3) != 0 || b >= cnt) continue;
    const int bb = b0 + lo + b;
    st_tagged(dst + (size_t)bb * FC + units[s], fmaxf(v + add[s * B + bb], 0.f), tag);
  }
}

// fc_pass for B9: the layer (0 fc1, 1 fc2) whose masks the table holds in
// tagl's top bits
template <typename WT>
__device__ __noinline__ void fc_pass_sp(const WT* W, int n, const float* tile,
                                        int nb, int b0, int nF, int FC, int B,
                                        const int* units, const float* add,
                                        u64* dst, uint32_t tagl) {
  const uint32_t tag = tagl & TAG_MASK;
  const int layer = (int)(tagl >> ID_SHIFT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n_groups(nF, nb, FC_ROWS);
  for (int it = warp; it < nF * ng; it += WARPS) {
    const int s = it / ng, gi = it % ng;
    const int lo = gi * nb / ng, cnt = (gi + 1) * nb / ng - lo;
    const uint32_t* tb = sparse_table();
    const int nw = (int)tb[H_NWR + layer];
    const uint32_t* m = tb + N_HEAD + tb[H_F1 + layer] + s * nw;
    const float v = unit_dots<1, FC_ROWS, WT, true>(W + (size_t)s * n, 0,
                                                    tile + (size_t)lo * n, n, cnt, m, nw);
    const int b = lane >> 2;
    if ((lane & 3) != 0 || b >= cnt) continue;
    const int bb = b0 + lo + b;
    st_tagged(dst + (size_t)bb * FC + units[s], fmaxf(v + add[s * B + bb], 0.f), tag);
  }
}

// count floats from global memory into shared dst, eight loads in flight a
// thread; all threads, between two __syncthreads
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int count) {
  __syncthreads();  // every warp is done with dst
  for (int e0 = threadIdx.x; e0 < count; e0 += 8 * THREADS) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = __ldg(src + min(e0 + q * THREADS, count - 1));
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (e0 + q * THREADS < count) dst[e0 + q * THREADS] = v[q];
  }
  __syncthreads();
}

// B10: step s's stream slice of block g (PB floats of the gathered (T, G,
// PB) streams) into plane slot s & 1, completing on mbarrier mb[s & 1]
// (thread 0)
__device__ __forceinline__ void stream_copy(float* plane, const float* streams, int PB,
                                            int G, int g, int s, uint64_t* mb) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(&mb[s & 1], (uint32_t)(PB * 4));
  bulk_g2s(plane + (size_t)(s & 1) * PB, streams + ((size_t)s * G + g) * PB,
           (uint32_t)(PB * 4), &mb[s & 1]);
}

// ROWS_G: the per-row regions lie in this block's slice of a.rows (many
// rows), not in shared memory. SP: B9's sparse arm (ARM_FUSED, or ARM_MAT
// with STATE).
template <typename WT, int ARM, bool STATE, bool PROF, bool ROWS_G, bool SP>
__global__ void __launch_bounds__(THREADS, 1) sample_loop_resident(ResArgs a) {
  constexpr bool FUSED = ARM == ARM_FUSED, MAT = ARM == ARM_MAT, V2 = ARM == ARM_V2;
  static_assert(!(SP && V2), "B10 has no sparse arm");
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = (int)a.B, R = (int)a.R, FC = (int)a.FC, A = (int)a.A;
  const int n_mels = (int)a.n_mels, NC = (int)a.NC, K = FUSED ? (int)a.K : 0;
  const int hop = FUSED ? (int)a.hop : 1, C = n_mels + 4 * A;
  const int T = FUSED ? (int)(a.fold_chunks * a.hop) : (int)a.T;
  const int n_index = FUSED ? (int)a.fold_chunks : T;  // conditioning indices
  const int G = (int)gridDim.x, g = (int)blockIdx.x;
  const int UR = (int)a.UR, UF = (int)a.UF, TR = (int)a.TR;
  const bool mol = a.mol != 0;
  const int nr = NC / 3;
  const int NU = mol ? nr + 1 : NC;
  const uint32_t key = lowbias32((uint32_t)a.seed);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wb = (int)sizeof(WT);

  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + a.off[S_MBAR]);
  long long* prof = reinterpret_cast<long long*>(smem + a.off[S_PROF]);
  WT* sWi1 = reinterpret_cast<WT*>(smem + a.off[S_WI1]);    // (UR, 3, R)
  WT* sWh1 = reinterpret_cast<WT*>(smem + a.off[S_WH1]);    // (UR, 3, R)
  WT* sWi2x = reinterpret_cast<WT*>(smem + a.off[S_WI2X]);  // (UR, 3, R)
  WT* sWh2 = reinterpret_cast<WT*>(smem + a.off[S_WH2]);    // (UR, 3, R)
  WT* sW1x = reinterpret_cast<WT*>(smem + a.off[S_W1X]);    // (UF, R)
  WT* sW2x = reinterpret_cast<WT*>(smem + a.off[S_W2X]);    // (UF, FC)
  // the conditioning matrices' rows: w_imel (UR, n_mels), w_ia1 (UR, A),
  // wi2a (UR, 3, A), w1a (UF, A), w2a (UF, A); formed where used (they
  // are used rarely, and a pointer held across the loop costs registers)
  auto cw = [&](int region) { return reinterpret_cast<WT*>(smem + a.off[region]); };
  // the per-row regions: shared memory, or (ROWS_G) this block's slice of
  // a.rows. B1's and B10's arms hold their pointers across the loop; B3's
  // forms them where used (`row_region`): either way round, one of the
  // arms spills. GH1 .. PLANE name a region as this instantiation holds
  // it; PLANE is index k's plane buffer (pl)
  constexpr bool ROWS_AT_USE = ROWS_G && MAT;
  unsigned char* rb = ROWS_G && !MAT
                          ? reinterpret_cast<unsigned char*>(a.rows) + (size_t)g * a.row_bytes
                          : smem;
  float* gh1 = reinterpret_cast<float*>(rb + a.off[S_GH1]);      // (UR, 3, B)
  float* gh2 = reinterpret_cast<float*>(rb + a.off[S_GH2]);      // (UR, 3, B)
  float* ownh1 = reinterpret_cast<float*>(rb + a.off[S_OWNH1]);  // (UR, B)
  float* ownh2 = reinterpret_cast<float*>(rb + a.off[S_OWNH2]);  // (UR, B)
  // (2, PB): per buffer gi2a (UR, 3, B), f1a (UF, B), f2a (UF, B); B10's
  // stream slice adds gi1 (UR, 3, B) and i (UR, B)
  float* plane = reinterpret_cast<float*>(rb + a.off[S_PLANE]);
  auto row_region = [&](int region) {
    unsigned char* base = reinterpret_cast<unsigned char*>(a.rows) + (size_t)g * a.row_bytes;
    return reinterpret_cast<float*>(base + a.off[region]);
  };
#define GH1 (ROWS_AT_USE ? row_region(S_GH1) : gh1)
#define GH2 (ROWS_AT_USE ? row_region(S_GH2) : gh2)
#define OWN1 (ROWS_AT_USE ? row_region(S_OWNH1) : ownh1)
#define OWN2 (ROWS_AT_USE ? row_region(S_OWNH2) : ownh2)
#define PLANE (ROWS_AT_USE ? row_region(S_PLANE) + (size_t)(k & 1) * PB : pl)
  float* sX = reinterpret_cast<float*>(smem + a.off[S_XOWN]);   // this block's rows' x
  float* sL = reinterpret_cast<float*>(smem + a.off[S_LOGIT]);  // (NC,)
  // owned R units' biases (bi1 r z n, bh1 r z n, bh2 r z n, b_I, bi2 r z
  // n; B10: wxw1 r z n, bh1, bh2, w_Ix, wxw2 r z n), owned FC units' (b1,
  // b2), then the owned units' indices: R-wide (UR,), FC-wide (UF,)
  float* sCR = reinterpret_cast<float*>(smem + a.off[S_CONST]);  // (UR, 13)
  float* sCF = sCR + (size_t)UR * 13;                              // (UF, 2)
  int* sUR = reinterpret_cast<int*>(sCF + (size_t)UF * 2);
  int* sUF = sUR + UR;
  float* tA = reinterpret_cast<float*>(smem + a.off[S_TA]);     // (TR, max(R, FC))
  float* tB = reinterpret_cast<float*>(smem + a.off[S_TB]);     // (max(TR, K + 2), R)
  const WT* w3 = a.w3_resident ? reinterpret_cast<const WT*>(smem + a.off[S_W3])
                               : reinterpret_cast<const WT*>(a.w3);
  const int PB = V2 ? (int)a.PBV : (3 * UR + 2 * UF) * B;
  const int PF = 3 * UR * B;  // f1a's offset in a plane buffer

  // the workspace: tagged words, two buffers (by step or index parity) each
  u64* vg = reinterpret_cast<u64*>(a.work);  // (2, B, R) stage-1 input
  u64* h1g = vg + (size_t)2 * B * R;         // (2, B, R)
  u64* h2g = h1g + (size_t)2 * B * R;        // (2, B, R)
  u64* xrg = h2g + (size_t)2 * B * R;        // (2, B, R)
  u64* x2g = xrg + (size_t)2 * B * R;        // (2, B, R)
  u64* hf1g = x2g + (size_t)2 * B * R;       // (2, B, FC)
  u64* hf2g = hf1g + (size_t)2 * B * FC;     // (2, B, FC)
  u64* baseg = hf2g + (size_t)2 * B * FC;    // (2, B, R)
  u64* psg = baseg + (size_t)2 * B * R;      // B1: (2, K, B, R)
  // then B9's done words (2, G) and B10's samples (2, B), formed where
  // used (held here, they cost the other arms registers)
#define DONE_WORDS (psg + (size_t)2 * K * B * R)
#define SAMPLE_WORDS (DONE_WORDS + (size_t)2 * G)

  const int32_t* ur = a.units_r + (size_t)g * UR;
  const int32_t* uf = a.units_fc + (size_t)g * UF;
  int nR = 0, nF = 0;  // units owned (a prefix of the slots)
  while (nR < UR && __ldg(ur + nR) >= 0) ++nR;
  while (nF < UF && __ldg(uf + nF) >= 0) ++nF;
  const bool sampler = g < B;  // rows g, g + G, ... are sampled here

  const WT* w_imel = reinterpret_cast<const WT*>(a.w_imel);
  const WT* w_ia1 = reinterpret_cast<const WT*>(a.w_ia1);
  const WT* wi2a = reinterpret_cast<const WT*>(a.wi2a);
  const WT* w1a = reinterpret_cast<const WT*>(a.w1a);
  const WT* w2a = reinterpret_cast<const WT*>(a.w2a);

#define SXA reinterpret_cast<float*>(smem + a.off[S_XALL])  // B10: (B,) samples
  // ---- profiling: cycles of block 0's thread 0 by (stage, kind) ----
  int pst = 0;
  long long plast = 0;
  auto mark = [&](int kind) {
    if constexpr (PROF) {
      if (g == 0 && threadIdx.x == 0) {
        const long long now = clock64();
        prof[pst * N_PKIND + kind] += now - plast;
        plast = now;
      }
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&mb[0], 1);
    if constexpr (V2) {
      mbar_init(&mb[1], 1);
      mbar_init(&mb[2], 1);
    }
    if constexpr (PROF) {
      for (int e = 0; e < N_PSTAGE * N_PKIND; ++e) prof[e] = 0;
      plast = clock64();
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // ---- the resident weights, one bulk copy per row ----
  if (threadIdx.x == 0) {
    const uint32_t rowR = R * wb, rowF = FC * wb;
    uint32_t bytes = nR * 12 * rowR + nF * (rowR + rowF);
    if (a.w3_resident && sampler) bytes += NC * rowF;
    mbar_expect_tx(&mb[0], bytes);
    const WT* src[4] = {(const WT*)a.wi1, (const WT*)a.wh1, (const WT*)a.wi2x,
                        (const WT*)a.wh2};
    WT* dst[4] = {sWi1, sWh1, sWi2x, sWh2};
    for (int s = 0; s < nR; ++s) {
      const int j = __ldg(ur + s);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          bulk_g2s(dst[m] + ((size_t)s * 3 + gt) * R,
                   src[m] + ((size_t)gt * R + j) * R, rowR, &mb[0]);
    }
    for (int s = 0; s < nF; ++s) {
      const int j = __ldg(uf + s);
      bulk_g2s(sW1x + (size_t)s * R, (const WT*)a.w1x + (size_t)j * R, rowR, &mb[0]);
      bulk_g2s(sW2x + (size_t)s * FC, (const WT*)a.w2x + (size_t)j * FC, rowF, &mb[0]);
    }
    if (a.w3_resident && sampler)
      bulk_g2s(smem + a.off[S_W3], a.w3, NC * rowF, &mb[0]);
    if constexpr (V2) {
      if (!ROWS_G && (nR > 0 || nF > 0)) stream_copy(plane, a.streams, PB, G, g, 0, mb + 1);
    }
  }
  if constexpr (!V2) {
    // the conditioning matrices' rows (any width: element copies, once)
    for (int e = threadIdx.x; e < nR * n_mels; e += THREADS) {
      const int s = e / n_mels, k = e % n_mels;
      cw(S_WIMEL)[e] = w_imel[(size_t)__ldg(ur + s) * n_mels + k];
    }
    for (int e = threadIdx.x; e < nR * A; e += THREADS) {
      const int s = e / A, k = e % A, j = __ldg(ur + s);
      cw(S_WIA1)[e] = w_ia1[(size_t)j * A + k];
      for (int gt = 0; gt < 3; ++gt)
        cw(S_WI2A)[((size_t)s * 3 + gt) * A + k] = wi2a[((size_t)gt * R + j) * A + k];
    }
    for (int e = threadIdx.x; e < nF * A; e += THREADS) {
      const int s = e / A, k = e % A, j = __ldg(uf + s);
      cw(S_W1A)[e] = w1a[(size_t)j * A + k];
      cw(S_W2A)[e] = w2a[(size_t)j * A + k];
    }
  }
  if constexpr (SP) {
    int32_t* dst = reinterpret_cast<int32_t*>(smem + SPARSE_OFF);
    for (int e = threadIdx.x; e < (int)a.SW; e += THREADS)
      if (e < H_DONE || e >= H_DONE + 2) dst[e] = __ldg(a.sparse + (size_t)g * a.SW + e);
    if (threadIdx.x == 0)  // the done words: B9's (2, G) after B1's taps
      *reinterpret_cast<u64**>(dst + H_DONE) = DONE_WORDS;
  }
  for (int e = threadIdx.x; e < UR; e += THREADS) sUR[e] = __ldg(ur + e);
  for (int e = threadIdx.x; e < UF; e += THREADS) sUF[e] = __ldg(uf + e);
  for (int e = threadIdx.x; e < nR * 13; e += THREADS) {
    const int q = e % 13, j = __ldg(ur + e / 13), gt = q < 9 ? q % 3 : (q - 10) & 3;
    if constexpr (V2)
      sCR[e] = q == 9 ? a.w_ix[j]
                      : (q < 3 ? a.wxw1 : q < 6 ? a.bh1 : q < 9 ? a.bh2 : a.wxw2)[gt * R + j];
    else
      sCR[e] = q == 9 ? a.b_i[j]
                      : (q < 3 ? a.bi1 : q < 6 ? a.bh1 : q < 9 ? a.bh2 : a.bi2)[gt * R + j];
  }
  for (int e = threadIdx.x; e < nF * 2; e += THREADS)
    sCF[e] = (e % 2 ? a.b2 : a.b1)[__ldg(uf + e / 2)];
  // the state entering step 0: owned units' h, this block's rows' x
  for (int e = threadIdx.x; e < nR * B; e += THREADS) {
    const int s = e / B, b = e % B, j = __ldg(ur + s);
    float h1 = 0.f, h2 = 0.f;
    if constexpr (STATE) {
      if (a.h1_0) h1 = a.h1_0[(size_t)b * R + j];
      if (a.h2_0) h2 = a.h2_0[(size_t)b * R + j];
    }
    OWN1[e] = h1;
    OWN2[e] = h2;
  }
  for (int r = threadIdx.x; g + r * G < B; r += THREADS) {
    float x = 0.f;
    if constexpr (STATE) {
      if (a.x_0) x = a.x_0[g + r * G];
    }
    sX[r] = x;
  }
  __syncthreads();

  // ---- tagged rows of an (., n) vector into a tile (B9: the chunks of the
  // list in tag's top bits) ----
  auto fetch = [&](float* dst, const u64* src, int count, uint32_t tag) {
    long long first;
    if constexpr (SP)
      first = fetch_listed<FUSED ? 4 : 2>(dst, src, count, tag);
    else
      first = fetch_tagged(dst, src, count, tag);
    if constexpr (PROF) {
      if (g == 0 && threadIdx.x == 0) {
        prof[pst * N_PKIND] += first - plast;
        plast = first;
      }
    }
    mark(1);
  };
#define FETCH(dst, src, count, l) \
  fetch(dst, src, count, tag | (SP ? (uint32_t)(l) << ID_SHIFT : 0u))

  // W_h h of the state rows in `tile`: the sums warp_dots kept in their
  // own accumulators
  auto hidden = [&](float* gh, const WT* W, const float* tile, int nb, int b0) {
    gru_pass<WT>(2, W, tile, nb, b0, nR, R, B, gh, nullptr, sCR, sUR, nullptr,
                 nullptr, nullptr, 0u);
  };
  // the arms' helpers take an extra operand (B9: the matrix or layer whose
  // masks apply, B10: its V2X); each call site picks at compile time, so
  // the dense arm's calls stay as they were (B10's hidden products are the
  // dense arm's)
#define HIDDEN(gh, W, tile, nb, b0, mi)                                                  \
  do {                                                                                   \
    if constexpr (SP)                                                                    \
      gru_pass_arm<WT, true, false>(2 | (mi) << 2, W, tile, nb, b0, nR, R, B, gh, nullptr, \
                                    sCR, sUR, nullptr, nullptr, nullptr, 0u);            \
    else                                                                                 \
      hidden(gh, W, tile, nb, b0);                                                       \
  } while (0)

  // ---- the conditioning of index k (B1: hop chunk k; B3: step k): tasks
  // of one (owned unit, kind) over up to 32 rows (B3's base: 16), a warp
  // each ----
  // global part: B1's mel taps p_j and base, B3's base (the samplers read
  // them, tagged k + 1); local part: gi2a, f1a, f2a of the owned units
  // B3: index k's conditioning rows (B x C floats) copied into tB once,
  // where they fit, for both parts' dots
  const bool staged = MAT && (size_t)B * C <= (size_t)max(TR, K + 2) * R;
  auto stage_rows = [&](int k) {
    if (staged) copy_rows(tB, a.cond + (size_t)k * B * C, B * C);
  };
  auto conditioning = [&](int k, bool global_part) {
    const int buf = k & 1;
    const uint32_t tag = (uint32_t)k + 1;
    const int H = 8;
    const int n_ch = (B + H - 1) / H;  // row chunks
    // kinds per owned R unit (global: B1 K taps + base, B3 base; local: 3
    // gi2a), then per owned FC unit (local: f1a, f2a)
    const int kr = global_part ? (FUSED ? K + 1 : 1) : 3;
    const int kf = global_part ? 0 : 2;
    const int n_tasks = (nR * kr + nF * kf) * n_ch;
    const float* rows = FUSED ? a.frames : a.cond + (size_t)k * B * C;
    if (!FUSED && staged) rows = tB;  // B3: the rows copied by stage_rows
    const float* aux = FUSED ? a.frames + ((size_t)(k + a.aux_tap) * B) * C + n_mels
                             : rows + n_mels;
    float* pl = (ROWS_AT_USE ? row_region(S_PLANE) : plane) + (size_t)buf * PB;
    if (MAT && global_part && k + 1 < n_index) {  // B3: the next step's rows
      const size_t line = (size_t)g * THREADS + threadIdx.x;  // 128-byte lines
      if (line * 32 < (size_t)B * C)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.cond + ((size_t)k + 1) * B * C
                                                      + line * 32));
    }
#pragma unroll 1
    for (int task = warp; task < n_tasks; task += WARPS) {
      const int r0 = task % n_ch * H, nb = min(H, B - r0);
      int q = task / n_ch;
      const WT *w = nullptr, *w2 = nullptr;
      const float* x = nullptr;
      int n = A, s, kind;
      if (q < nR * kr) {
        s = q / kr;
        kind = q % kr;
        if (global_part && FUSED && kind < K) {
          w = cw(S_WIMEL) + (size_t)s * n_mels;
          x = a.frames + ((size_t)(k + kind) * B) * C;
          n = n_mels;
        } else if (global_part && FUSED) {
          w = cw(S_WIA1) + (size_t)s * A;
          x = aux;
        } else if (global_part) {  // B3's base: mel half, then a1 half
          w = cw(S_WIMEL) + (size_t)s * n_mels;
          x = rows;
          n = n_mels;
          w2 = cw(S_WIA1) + (size_t)s * A;
        } else {
          w = cw(S_WI2A) + ((size_t)s * 3 + kind) * A;
          x = aux + A;
        }
      } else {
        q -= nR * kr;
        s = q / kf;
        kind = 3 + q % kf;  // 3: f1a, 4: f2a
        w = cw(kind == 3 ? S_W1A : S_W2A) + (size_t)s * A;
        x = aux + (kind - 1) * A;
      }
      const float sum = cond_dots<WT>(w, x + (size_t)r0 * C, n, C, nb);
      const float a1 = w2 ? cond_dots<WT>(w2, aux + (size_t)r0 * C, A, C, nb) : 0.f;
      if ((lane & 3) != 0 || (lane >> 2) >= nb) continue;
      const int b = r0 + (lane >> 2);
      if (global_part) {
        const int j = sUR[s];
        if (FUSED && kind < K) {
          st_tagged(psg + (((size_t)buf * K + kind) * B + b) * R + j, sum, tag);
        } else if (FUSED) {
          st_tagged(baseg + ((size_t)buf * B + b) * R + j, sum + sCR[s * 13 + 9], tag);
        } else {
          float s2 = sum;
          s2 += a1;
          st_tagged(baseg + ((size_t)buf * B + b) * R + j, s2 + sCR[s * 13 + 9], tag);
        }
      } else if (kind < 3) {
        pl[((size_t)s * 3 + kind) * B + b] = sum + sCR[s * 13 + 10 + kind];
      } else {
        pl[PF + ((size_t)(kind - 3) * UF + s) * B + b] = sum + sCF[s * 2 + kind - 3];
      }
    }
  };

  // ---- this block's rows' stage-1 input for step tn: base, the taps and
  // w_Ix loaded (tagged) into tB before the sample is drawn (each thread
  // its own columns), the chain after ----
  float phin[KMAX];
  auto preload_v = [&](int tn, int b) {
    const int kn = FUSED ? tn / hop : tn, in = FUSED ? tn % hop : 0, buf = kn & 1;
    const uint32_t tag = (uint32_t)kn + 1;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) phin[j] = (FUSED && j < K) ? a.phi[j * hop + in] : 0.f;
    for (int k0 = threadIdx.x; k0 < R; k0 += 2 * THREADS) {
      u64 w[2][KMAX + 1];  // two columns' loads all in flight, then checked
      bool ok;
      unsigned spins = 0;
      do {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = min(k0 + h * THREADS, R - 1);
          w[h][0] = ld_tagged(baseg + ((size_t)buf * B + b) * R + k);
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j < K) w[h][1 + j] = ld_tagged(psg + (((size_t)buf * K + j) * B + b) * R + k);
        }
        ok = true;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ok &= has_tag(w[h][0], tag);
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j < K) ok &= has_tag(w[h][1 + j], tag);
        }
        if (!ok) spin_guard(spins);
      } while (!ok);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + h * THREADS;
        if (k >= R) continue;
        tB[k] = tagged_value(w[h][0]);
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K) tB[(size_t)(1 + j) * R + k] = tagged_value(w[h][1 + j]);
        tB[(size_t)(K + 1) * R + k] = a.w_ix[k];
      }
    }
  };
  auto store_v = [&](int tn, int b, float xv) {
    u64* dst = vg + ((size_t)(tn & 1) * B + b) * R;
    for (int k = threadIdx.x; k < R; k += THREADS) {
      float v = tB[k] + xv * tB[(size_t)(K + 1) * R + k];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) v = v + phin[j] * tB[(size_t)(1 + j) * R + k];
      st_tagged(dst + k, v, (uint32_t)tn + 1);
    }
  };

  // ---- prologue: index 0's conditioning (B3: and index 1's global part),
  // v for step 0 (B10: the samples x = 0), W_h h of the state ----
  if constexpr (!V2) {
    stage_rows(0);
    conditioning(0, true);
    conditioning(0, false);
    if (MAT && T > 1) {
      stage_rows(1);
      conditioning(1, true);
    }
    __syncthreads();  // tB's rows are read before the preload overwrites them
    for (int r = 0; sampler && g + r * G < B; ++r) {
      preload_v(0, g + r * G);
      store_v(0, g + r * G, sX[r]);
    }
  } else {
    for (int r = threadIdx.x; sampler && g + r * G < B; r += THREADS)
      st_tagged(SAMPLE_WORDS + g + r * G, sX[r], 1u);
  }
  mbar_wait(&mb[0], 0);  // the resident weights have landed
  for (int m = 0; m < 2; ++m) {
    const float* h0 = m == 0 ? a.h1_0 : a.h2_0;
    for (int b0 = 0; b0 < B; b0 += TR) {
      const int nb = min(TR, B - b0);
      __syncthreads();
      for (int e = threadIdx.x; e < nb * R; e += THREADS)
        tB[e] = (STATE && h0) ? h0[(size_t)b0 * R + e] : 0.f;
      __syncthreads();
      HIDDEN(m == 0 ? GH1 : GH2, m == 0 ? sWh1 : sWh2, tB, nb, b0, m == 0 ? 1 : 3);
    }
  }
  __syncthreads();
  mark(4);

  // one tile holds every row: a block forms xr = v + h1 and x2 = xr + h2
  // itself (the sums the writers formed, bit for bit), and reads only h1
  // and h2 of them; with several tiles it reads xr and x2 as written
  // (B10 always: its x2's owner forms it)
  const bool one_tile = TR >= B;
  const bool local_x = !V2 && one_tile;
  const bool acts = nR > 0 || nF > 0;  // a block that owns no unit reads none
  // Work off the critical path goes where this block would wait. Where
  // the sampling blocks own no unit (the plan's `exclusive`, few rows),
  // the others form the next step's hidden products (with one tile of
  // rows) during stage 5, while the rows are sampled; otherwise after
  // stages 2 and 3. B3's conditioning (the next step's local part, the
  // step after's global part) follows stage 1.
  const bool late_hidden = a.exclusive && !sampler && one_tile && nR > 0;
  auto add_tile = [&](float* dst, const float* src, int count) {
    for (int e = threadIdx.x; e < count / 4; e += THREADS) {
      float4 u = reinterpret_cast<float4*>(dst)[e];
      const float4 v = reinterpret_cast<const float4*>(src)[e];
      u.x = u.x + v.x;
      u.y = u.y + v.y;
      u.z = u.z + v.z;
      u.w = u.w + v.w;
      reinterpret_cast<float4*>(dst)[e] = u;
    }
    __syncthreads();
  };

  for (int t = 0; t < T; ++t) {
    const int k = FUSED ? t / hop : t, i = FUSED ? t % hop : 0;
    // B10: step t's stream slice, in shared memory or (ROWS_G) in place
    const float* pl = V2 && ROWS_G ? a.streams + ((size_t)t * G + g) * PB
                                   : plane + (size_t)(k & 1) * PB;
    const size_t cur = (size_t)(t & 1);
    const uint32_t tag = (uint32_t)t + 1;
    // the next index's conditioning is due once per index (B1: at its
    // chunk's first step; B3: every step)
    const bool next_due = (FUSED ? i == 0 : true) && k + 1 < n_index;
    if constexpr (STATE) {
      if (t == a.snapshot_at) {
        for (int e = threadIdx.x; e < nR * B; e += THREADS) {
          const int s = e / B, b = e % B, j = sUR[s];
          a.snap_h1[(size_t)b * R + j] = OWN1[e];
          a.snap_h2[(size_t)b * R + j] = OWN2[e];
        }
        for (int r = threadIdx.x; g + r * G < B; r += THREADS) a.snap_x[g + r * G] = sX[r];
      }
    }

    pst = 1;
    if constexpr (V2) {
      // ---- B10 stage 1: the streams of step t (the next step's on their
      // way), the B samples, then GRU1's gates ----
      if (acts) {
        if constexpr (ROWS_G) {
          if (t + 1 < T) {
            const float* nx = a.streams + ((size_t)(t + 1) * G + g) * PB;
            for (int l = threadIdx.x; l * 32 < PB; l += THREADS)
              asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + (size_t)l * 32));
          }
        } else {
          __syncthreads();  // every warp is past step t - 1's reads of slot t + 1
          if (threadIdx.x == 0 && t + 1 < T)
            stream_copy(plane, a.streams, PB, G, g, t + 1, mb + 1);
          mbar_wait(&mb[1 + (t & 1)], (uint32_t)(t >> 1) & 1u);
        }
      }
      if (nR > 0) {
        poll_words(SXA, SAMPLE_WORDS + cur * B, B, tag);
        mark(1);
        v2_gru1(pl + PF + 2 * UF * B, SXA, GH1, sCR, sUR, OWN1, h1g + cur * B * R, nR, R,
                B, tag);
        mark(2);
      }
      mark(4);

      // ---- B10 stage 2: GRU2 on the new h1; then W_h1 h1 for the next
      // step ----
      pst = 2;
      for (int b0 = 0; nR > 0 && b0 < B; b0 += TR) {
        const int nb = min(TR, B - b0);
        fetch(tA, h1g + (cur * B + b0) * R, nb * R, tag);
        gru_pass_arm<WT, false, true>(1, sWi2x, tA, nb, b0, nR, R, B, GH2, pl, sCR, sUR, OWN2,
                                      h2g + cur * B * R, x2g + cur * B * R, tag,
                                      V2X{SXA, pl + PF + 2 * UF * B + 3 * UR * B, OWN1});
        mark(2);
        if (!late_hidden) HIDDEN(GH1, sWh1, tA, nb, b0, 1);
        mark(4);
      }
    } else {
      // ---- stage 1: GRU1 on v; then the next index's conditioning ----
      for (int b0 = 0; acts && b0 < B; b0 += TR) {
        const int nb = min(TR, B - b0);
        FETCH(tA, vg + (cur * B + b0) * R, nb * R, L_V);
        if constexpr (SP)
          gru_pass_arm<WT, true, false>(0, sWi1, tA, nb, b0, nR, R, B, GH1, nullptr, sCR, sUR,
                                        OWN1, h1g + cur * B * R,
                                        local_x ? nullptr : xrg + cur * B * R, tag);
        else
          gru_pass<WT>(0, sWi1, tA, nb, b0, nR, R, B, GH1, nullptr, sCR, sUR, OWN1,
                       h1g + cur * B * R, local_x ? nullptr : xrg + cur * B * R, tag);
        mark(2);
      }
      if (FUSED && next_due) {  // tB is free until stage 2
        conditioning(k + 1, true);
        conditioning(k + 1, false);
      }
      if constexpr (MAT) {
        if (acts && k + 1 < T) {
          stage_rows(k + 1);
          conditioning(k + 1, false);
        }
        if (acts && k + 2 < T) {
          stage_rows(k + 2);
          conditioning(k + 2, true);
        }
      }
      mark(4);

      // ---- stage 2: GRU2 on [xr | a2]; then W_h1 h1 for the next step ----
      pst = 2;
      for (int b0 = 0; acts && b0 < B; b0 += TR) {
        const int nb = min(TR, B - b0);
        if (local_x) {  // tA: v -> xr = v + h1
          FETCH(tB, h1g + (cur * B + b0) * R, nb * R, L_H1);
          add_tile(tA, tB, nb * R);
        } else {
          FETCH(tA, xrg + (cur * B + b0) * R, nb * R, L_XR);
          FETCH(tB, h1g + (cur * B + b0) * R, nb * R, L_H1);
        }
        if constexpr (SP)
          gru_pass_arm<WT, true, false>(1 | 2 << 2, sWi2x, tA, nb, b0, nR, R, B, GH2, PLANE,
                                        sCR, sUR, OWN2, h2g + cur * B * R,
                                        local_x ? nullptr : x2g + cur * B * R, tag);
        else
          gru_pass<WT>(1, sWi2x, tA, nb, b0, nR, R, B, GH2, PLANE, sCR, sUR, OWN2,
                       h2g + cur * B * R, local_x ? nullptr : x2g + cur * B * R, tag);
        mark(2);
        if (nR > 0 && !late_hidden) HIDDEN(GH1, sWh1, tB, nb, b0, 1);
        mark(4);
      }
    }

    // ---- stage 3: fc1 on x2; then W_h2 h2 for the next step ----
    pst = 3;
    for (int b0 = 0; acts && b0 < B; b0 += TR) {
      const int nb = min(TR, B - b0);
      if (local_x) {  // tA: xr -> x2 = xr + h2
        FETCH(tB, h2g + (cur * B + b0) * R, nb * R, L_H2);
        add_tile(tA, tB, nb * R);
      } else {
        if (nF > 0) FETCH(tA, x2g + (cur * B + b0) * R, nb * R, L_X2);
        if (nR > 0) FETCH(tB, h2g + (cur * B + b0) * R, nb * R, L_H2);
      }
      if constexpr (SP)
        fc_pass_sp<WT>(sW1x, R, tA, nb, b0, nF, FC, B, sUF, PLANE + PF, hf1g + cur * B * FC,
                       tag);
      else
        fc_pass<WT>(sW1x, R, tA, nb, b0, nF, FC, B, sUF, PLANE + PF,
                    hf1g + cur * B * FC, tag);
      mark(2);
      if (nR > 0 && !late_hidden) HIDDEN(GH2, sWh2, tB, nb, b0, 3);
      mark(4);
    }

    // ---- stage 4: fc2 ----
    pst = 4;
    for (int b0 = 0; nF > 0 && b0 < B; b0 += TR) {
      const int nb = min(TR, B - b0);
      FETCH(tA, hf1g + (cur * B + b0) * FC, nb * FC, L_HF1);
      if constexpr (SP)
        fc_pass_sp<WT>(sW2x, FC, tA, nb, b0, nF, FC, B, sUF, PLANE + PF + (size_t)UF * B,
                       hf2g + cur * B * FC, tag | 1u << ID_SHIFT);
      else
        fc_pass<WT>(sW2x, FC, tA, nb, b0, nF, FC, B, sUF, PLANE + PF + (size_t)UF * B,
                    hf2g + cur * B * FC, tag);
      mark(2);
    }
    // the first sampled row's next input, preloaded while stage 4's outputs
    // land (tB: every warp is past stage 3's reads)
    if (!V2 && sampler && t + 1 < T) {
      __syncthreads();
      preload_v(t + 1, g);
    }
    mark(4);

    // ---- stage 5: fc3 and the sample, one block per row; then that row's
    // stage-1 input for the next step (B10: the sample). The other blocks
    // meanwhile: the next step's W_h2 h2 (tB holds h2) and W_h1 h1 (h1
    // fetched again), B3's conditioning ----
    pst = 5;
    if (late_hidden) {
      HIDDEN(GH2, sWh2, tB, B, 0, 3);
      FETCH(tA, h1g + cur * B * R, B * R, L_H1);
      HIDDEN(GH1, sWh1, tA, B, 0, 1);
    }
    if (!sampler) mark(4);
    for (int r = 0; sampler && g + r * G < B; ++r) {
      const int b = g + r * G;
      const size_t ctr0 = ((size_t)t * B + b) * NU;
      if (!V2 && r > 0 && t + 1 < T) {  // further rows of this block (B > G)
        __syncthreads();
        preload_v(t + 1, b);
      }
      // the draw's noise terms before the wait: lane c's uniform c (c <
      // 32); MOL's log(-log u) of the mixture pick and the logistic
      // term log u - log(1 - u); the next step's row of injected uniforms
      // on its way to L2
      float u_lane = 0.f, gum = 0.f, logistic = 0.f;
      if (warp == 0) {
        if (lane < NU)
          u_lane = a.noise ? __ldg(a.noise + ctr0 + lane)
                           : counter_uniform(key, (uint32_t)(ctr0 + lane), mol);
        if (mol) {
          gum = logf(-logf(u_lane));
          const float u_nr = __shfl_sync(0xffffffffu, u_lane, nr & 31);
          const float us = nr < 32 ? u_nr
              : (a.noise ? __ldg(a.noise + ctr0 + nr)
                         : counter_uniform(key, (uint32_t)(ctr0 + nr), mol));
          logistic = logf(us) - logf(1.f - us);
        }
      }
      if (a.noise && t + 1 < T && threadIdx.x * 32 < NU)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.noise + ((size_t)(t + 1) * B + b) * NU
                                                      + threadIdx.x * 32));
      mark(4);
      // B9: the first row's fetch first waits for every acting block's
      // done word (each is past its reads of step t - 1)
      FETCH(tA, hf2g + (cur * B + b) * FC, FC, r == 0 ? L_DONE : L_ALL);
      // classes c0 + 8q, q < NQ, a warp's dots interleaved (a class past
      // NC reads c0's row again); two at a time keep the registers within
      // 255 with no spill in every instantiation
      constexpr int NQ = 2;
      for (int c0 = warp; c0 < NC; c0 += NQ * WARPS) {
        int rw[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          rw[q] = (c0 + q * WARPS < NC ? c0 + q * WARPS : c0) * FC;
        float acc[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
        for (int k0 = lane * 8; k0 < FC; k0 += 256) {
          float x8[8];
          ld8(tA + k0, x8);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float w8[8];
            ld8(w3 + rw[q] + k0, w8);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[q] = fmaf(w8[e], x8[e], acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] = warp_sum(acc[q]);
        if (lane == 0)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            if (c0 + q * WARPS < NC) sL[c0 + q * WARPS] = acc[q] + a.b3[c0 + q * WARPS];
      }
      __syncthreads();
      mark(2);
      if (warp == 0) {
        float best = -INFINITY;
        int idx = 0x7fffffff;
        float sample;
        if (mol) {
          if (lane < nr) {
            best = sL[lane] - gum;
            idx = lane;
          }
          warp_argmax(best, idx);
          const float mean = sL[nr + idx];
          const float log_s = fmaxf(sL[2 * nr + idx], LOG_SCALE_MIN);
          sample = mean + expf(log_s) * logistic;
          sample = fminf(fmaxf(sample, -1.f), 1.f);
        } else {
          for (int c = lane; c < NC; c += 32) {
            const float u = c < 32 ? u_lane
                : (a.noise ? __ldg(a.noise + ctr0 + c)
                           : counter_uniform(key, (uint32_t)(ctr0 + c), mol));
            const float v = sL[c] + -logf(-logf(u));
            if (v > best) {
              best = v;
              idx = c;
            }
          }
          warp_argmax(best, idx);
          sample = 2.f * (float)idx / ((float)NC - 1.f) - 1.f;
        }
        if (lane == 0) {
          a.out[(size_t)b * T + t] = sample;
          sX[r] = sample;
          if constexpr (V2) {
            if (t + 1 < T) st_tagged(SAMPLE_WORDS + (size_t)((t + 1) & 1) * B + b, sample, tag + 1);
          }
        }
      }
      __syncthreads();
      mark(3);
      if (!V2 && t + 1 < T) store_v(t + 1, b, sX[r]);
      mark(5);
    }
  }

  if constexpr (STATE) {
    if (a.snapshot_at == T) {
      for (int e = threadIdx.x; e < nR * B; e += THREADS) {
        const int s = e / B, b = e % B, j = __ldg(ur + s);
        a.snap_h1[(size_t)b * R + j] = OWN1[e];
        a.snap_h2[(size_t)b * R + j] = OWN2[e];
      }
      for (int r = threadIdx.x; g + r * G < B; r += THREADS) a.snap_x[g + r * G] = sX[r];
    }
  }
  if constexpr (PROF) {
    if (g == 0 && threadIdx.x == 0) {
      for (int e = 0; e < N_PSTAGE * N_PKIND; ++e) a.prof[e] = prof[e];
      a.prof[N_PSTAGE * N_PKIND] = T;
    }
  }
}

#undef FETCH
#undef HIDDEN
#undef DONE_WORDS
#undef SAMPLE_WORDS
#undef SXA
#undef GH1
#undef GH2
#undef OWN1
#undef OWN2
#undef PLANE

int launch(const void* fn, const ResArgs* args, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)args->smem_bytes;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (e != cudaSuccess) return e;
  // every block must be resident at once: readers spin on other blocks' words
  if (per_sm < 1 || args->G > (int64_t)per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  ResArgs a = *args;
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)args->G), dim3(THREADS), kargs,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// which: 0 B1, 1 B4b, 2 B3 with B4a, 3 B1 sparse (B9), 4 B3 sparse (B9),
// 5 B10; RG: the per-row regions in a.rows
template <bool RG>
int entry(int which, const ResArgs* args, void* stream) {
  typedef __nv_bfloat16 H;
  const bool bf = args->bf16;
  const void* fn = nullptr;
  switch (which) {
    case 0:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_FUSED, false, false, RG, false>
              : (const void*)sample_loop_resident<float, ARM_FUSED, false, false, RG, false>;
      break;
    case 1:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_FUSED, true, false, RG, false>
              : (const void*)sample_loop_resident<float, ARM_FUSED, true, false, RG, false>;
      break;
    case 2:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_MAT, true, false, RG, false>
              : (const void*)sample_loop_resident<float, ARM_MAT, true, false, RG, false>;
      break;
    case 3:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_FUSED, false, false, RG, true>
              : (const void*)sample_loop_resident<float, ARM_FUSED, false, false, RG, true>;
      break;
    case 4:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_MAT, true, false, RG, true>
              : (const void*)sample_loop_resident<float, ARM_MAT, true, false, RG, true>;
      break;
    default:
      fn = bf ? (const void*)sample_loop_resident<H, ARM_V2, false, false, RG, false>
              : (const void*)sample_loop_resident<float, ARM_V2, false, false, RG, false>;
  }
  return launch(fn, args, stream);
}

int entry_any(int which, const ResArgs* args, void* stream) {
  return args->rows ? entry<true>(which, args, stream) : entry<false>(which, args, stream);
}

}  // namespace

extern "C" {

// Floats of workspace a launch needs (zero-filled by the caller): two
// buffers of tagged words (two floats each) for the seven (B, width) step
// vectors, base, (B1) the K mel taps, (B9) G done words and (B10) B
// samples.
int64_t wr_resident_work_floats(int64_t B, int64_t R, int64_t FC, int64_t K,
                                int64_t G) {
  return 2 * 2 * B * (5 * R + 2 * FC + R + K * R) + 2 * 2 * (G + B);
}

// B1: the fused loop on `stream`; returns the CUDA error code (0 = launched).
int wr_resident_fused(const ResArgs* args, void* stream) {
  return entry_any(0, args, stream);
}

// B4b: the fused loop with state I/O.
int wr_resident_fused_state(const ResArgs* args, void* stream) {
  return entry_any(1, args, stream);
}

// B3 with B4a: the materialized loop with state I/O.
int wr_resident_materialized(const ResArgs* args, void* stream) {
  return entry_any(2, args, stream);
}

// B9: B1's sparse arm (args->sparse: the per-block table).
int wr_resident_fused_sparse(const ResArgs* args, void* stream) {
  return args->sparse ? entry_any(3, args, stream) : cudaErrorInvalidValue;
}

// B9: B3's sparse arm, with state I/O.
int wr_resident_materialized_sparse(const ResArgs* args, void* stream) {
  return args->sparse ? entry_any(4, args, stream) : cudaErrorInvalidValue;
}

// B10: the loop on the gathered streams (args->streams).
int wr_resident_v2(const ResArgs* args, void* stream) {
  return args->streams ? entry_any(5, args, stream) : cudaErrorInvalidValue;
}

// clock64() stamps on block 0 into args->prof (bfloat16 weights, the
// per-row regions in shared memory only): the per-stage split of a step
// of B10 (args->streams), B1's sparse arm (args->sparse), B3 (args->cond)
// or B1. Not on any serving path.
int wr_resident_profile(const ResArgs* args, void* stream) {
  typedef __nv_bfloat16 H;
  if (!args->bf16 || !args->prof || args->rows) return cudaErrorInvalidValue;
  const void* fn =
      args->streams ? (const void*)sample_loop_resident<H, ARM_V2, false, true, false, false>
      : args->sparse ? (const void*)sample_loop_resident<H, ARM_FUSED, false, true, false, true>
      : args->cond ? (const void*)sample_loop_resident<H, ARM_MAT, true, true, false, false>
                   : (const void*)sample_loop_resident<H, ARM_FUSED, false, true, false, false>;
  return launch(fn, args, stream);
}

}  // extern "C"
