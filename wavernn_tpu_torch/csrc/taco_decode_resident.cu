// Tacotron free-running decode for Hopper (sm_90a), redesigned around the
// card: kernels B2 (one utterance) and B8 (a batch with a stop and freeze
// per row) on one body, taco_dec_res, one cooperative launch for every
// decoder group of the whole batch, one block per SM, 256 threads. B2 is
// its one-row instantiation (a warp's tile of 1 row), B8 the instantiation
// with tiles of 8 rows. Every decode launch runs here; csrc/taco_decode.cu
// (taco_decode, taco_decode_batch) is the yardstick, reached only through
// the wrappers' private _legacy=True.
//
// Replaces: wavernn_tpu/ops/pallas_taco.py, _make_kernel (:74, called at
// :631 through decode_pallas: B2), _make_batch_kernel (:207, called at
// :516 through decode_pallas_batch, B <= 8) and _make_stacked_kernel (:678,
// called at :877 through decode_pallas_stacked, B > 8). ops/cuda_taco.py
// holds the wrappers, the launch plan (decode_resident_plan) and the plain
// versions (decode_ref, decode_batch_ref).
//
// What it computes is csrc/taco_decode.cu's function (its head note has the
// equations), per group g and row b: the prenet on the row's last frame,
// the attention GRUCell on [ctx | p], the query, the location-sensitive
// smooth attention under the row's text mask, the context, rnn_input on
// [ctx | ah], two residual LSTMCells, mel_proj's r frames and the stop test
// (all(mel < thr) and g*r > 10). A row that stops keeps its state from then
// on and emits its frozen-state output; n_valid counts its groups up to and
// including the trigger; once every row has stopped, the next group's
// output is replayed to the end.
//
// What bounds it: latency. At B 32, T_text 43, 200 groups the work is
// about 71 GFLOP (1.07 ms at 67 TF/s float32); at B 1 about 2.2 GFLOP. The
// limit is the chain of 200 dependent groups, each a chain of stages that
// need the previous stage's whole output on every row.
//
// Design, against the original body's split (tools/probe_b8_split.py: at
// B 1 its ten grid barriers are a third of a group, at B 32 the matrix
// stages three quarters, every weight row read from L2 once per 4-row
// tile; block 0 writes every output):
//  1. Weights resident by units. Unit j of every matrix stage belongs to
//     block j mod grid; the rows of the block's units (every gate) are
//     copied once a launch by cp.async.bulk onto an mbarrier, where the
//     plan (ops/cuda_taco.py, decode_resident_plan, mirrored by DecPlan)
//     has room, the chain's LSTM rows first; the rest are read from device
//     memory (through L1).
//  2. Inputs. One row (B2) is read in place through L2 by the warps that
//     need it, with no block barrier. Several rows are staged: a pass of
//     up to 32 rows (as many as give each warp one (unit, tile of 8 rows)
//     item) is copied into shared memory a chunk of columns at a time by
//     cp.async into two buffers, the next chunk in flight during this
//     one's products; each row's ping-pong buffer by its own index.
//  3. Off the chain. What needs only the state entering group g is
//     computed between a barrier's arrive and its wait early in group g:
//     the GRUCell's ctx half of the input product and its hidden product
//     with their biases (slack 1), the location features encp_t + L
//     conv([cum; att])_t of the block's attention items (slack 2), the
//     LSTMs' hidden products with their biases (slacks 3 and 4). The chain
//     keeps prenet fc1 -> fc2 -> the GRUCell's p half -> query -> the
//     energies and context -> rnn_input -> the LSTMs' input halves ->
//     mel_proj: nine split-barrier intervals a group.
//  4. The attention in items of 4, 8 or 16 text positions of one row (the
//     fewest that leave every block one item where they can), item i on
//     block i mod grid: the energies v . tanh(q + e_t) from the item's
//     location features, the unnormalised sigmoids under the mask, their
//     partial sum and the partial context sum_t sig_t enc_t. The row's
//     last item to arrive at an acq_rel count sums the partials in item
//     order: the normaliser, ctx = sum / total, the scores (the group's
//     attention output) and the cumulative.
//  5. Barriers: a split counter barrier (DBar: res::Bar's protocol, a
//     release add and acquire polls instead of full fences), the
//     off-chain pieces between arrive and wait. A piece run between
//     arrive(k) and wait(k) is seen by every block from interval k + 2 on,
//     and what it reads (the state entering the group, index ci) is not
//     written in the group (the group writes index ci ^ 1).
//  6. The stop. A block that owns mel units flags each row with a value
//     not below the threshold (an atomic max of the group's number); after
//     the last barrier every block reads the rows' flags and keeps the same
//     per-row ping-pong index, stop flag and count, so the host never
//     synchronises inside the loop.
//  7. Outputs are written by the blocks that own the mel units and the
//     rows' last items; the replay of the held group is spread over the
//     grid.
//  8. Any B and T_text in one launch: the plan puts what does not fit a
//     block's shared memory in device memory.
// Sums in other orders than the plain version's: the GRUCell's input
// product in its ctx and p halves, each LSTM gate's two halves, e = encp +
// L loc before q is added, the context as a sum of partials divided once.
// Not used: tensor cores (float32, no TF32), clusters.
#define TACO_TRAIN_HELPERS_ONLY 1
#include "taco_train_resident.cu"

// Mirrored field for field by ops/cuda_taco.py (_ResArgs): 8-byte fields.
struct ResArgs {
  const float* enc;    // (B, T, E)
  const float* encp;   // (B, T, D)
  const float* mask;   // (B, T)          1 on a row's text, 0 on its padding
  const float* w1p;    // (P1, n_mels)    prenet fc1
  const float* b1p;
  const float* w2p;    // (P2, P1)        prenet fc2
  const float* b2p;
  const float* awi;    // (3D, E + P2)    attention GRUCell, input [ctx | p]
  const float* abi;
  const float* awh;    // (3D, D)
  const float* abh;
  const float* wq;     // (D, D)          attn W
  const float* qb;     // (D,)            W.b + L.b
  const float* conv;   // (32, 2, 31)     location conv
  const float* lwt;    // (32, D)         attn L, transposed
  const float* v;      // (D,)
  const float* wr;     // (L, E + D)      rnn_input, input [ctx | ah]
  const float* br;
  const float* l1wi;   // (4L, L)
  const float* l1wh;
  const float* l1b;    // (4L,)           bias_ih + bias_hh
  const float* l2wi;
  const float* l2wh;
  const float* l2b;
  const float* wm;     // (F, L)          mel_proj rows of the r frames
  float* mel_out;      // (B, n_groups, F)
  float* att_out;      // (B, n_groups, T)
  int32_t* n_valid;    // (B,)
  float* work;         // zeroed workspace, see DWork
  long long* prof;     // the profiling instantiation's cycles (DProf), or null
  int64_t B, T, E, D, P1, P2, L, n_mels, r, n_groups;
  double stop_threshold;
};

// The launch plan, computed by ops/cuda_taco.py (decode_resident_plan) and
// mirrored there field for field: 8-byte fields only. Offsets are in floats
// into the dynamic shared memory (the weights' mbarrier sits at 0); a
// weight group's rows sit at its off_* where its res_* is set, laid out by
// (the block's unit m, gate), else they are read from device memory.
struct DecPlan {
  int64_t nblk;        // grid: one block per SM
  int64_t smem_bytes;
  int64_t rt;          // rows of a warp's tile: 1 (read in place) or 8 (staged)
  int64_t rows;        // rows of a staged pass (a multiple of 8, at most 32)
  int64_t kc;          // columns of a staged chunk (a multiple of 128)
  int64_t off_x;       // two chunk buffers: 2 x rows x kc
  int64_t off_conv;    // (32, 2, 31)
  int64_t off_v;       // (D,)
  int64_t off_att;     // the attention scratch
  int64_t off_rows;    // per-row bookkeeping: 5 x B
  int64_t ti;          // text positions of an attention item: 4, 8 or 16
  int64_t nc;          // attention items per row: ceil(T / ti)
  int64_t ipb;         // attention items a block owns at most
  int64_t e_smem;      // the items' location features in shared memory
  int64_t off_e;       // (ipb, 16, D): item m's features at m * 16 * D
  int64_t res_fc1, off_fc1;
  int64_t res_fc2, off_fc2;
  int64_t res_awi, off_awi;
  int64_t res_awh, off_awh;
  int64_t res_wq, off_wq;
  int64_t res_wr, off_wr;
  int64_t res_l1wi, off_l1wi;
  int64_t res_l1wh, off_l1wh;
  int64_t res_l2wi, off_l2wi;
  int64_t res_l2wh, off_l2wh;
  int64_t res_wm, off_wm;
};

namespace decres {

using res::Prof;
using res::u64;

constexpr int LOC_CH = 32;                  // location conv channels
constexpr int WINP = 48;                    // an item's window of positions, padded
// the attention scratch (ATT_FLOATS in ops/cuda_taco.py): windows of the
// cumulative and the attention, the warps' partial energies, the energies,
// 16 spare, the item's conv outputs
constexpr int ATT_RED = 2 * WINP;
constexpr int ATT_U = ATT_RED + WARPS * TC;
constexpr int ATT_MISC = ATT_U + TC;
constexpr int ATT_LOC = ATT_MISC + 16;
constexpr int ATT_FLOATS = ATT_LOC + TC * LOC_CH;

// profile labels (cycles summed over groups, block 0): per stage its work,
// the off-chain piece after its arrive, its wait (RES_PROF in the wrapper)
enum DProf {
  DP_FC1, DP_FC1_S, DP_FC1_W, DP_FC2, DP_FC2_S, DP_FC2_W, DP_GRU, DP_GRU_S, DP_GRU_W,
  DP_Q, DP_Q_S, DP_Q_W, DP_ITEMS, DP_ITEMS_S, DP_ITEMS_W, DP_RNN, DP_RNN_S, DP_RNN_W,
  DP_L1, DP_L1_S, DP_L1_W, DP_L2, DP_L2_S, DP_L2_W, DP_MEL, DP_MEL_S, DP_MEL_W, DP_STOP,
  DP_PRO, DP_N
};
// and, from DP_N on, the split inside the stages and the items (summed over
// every stage or item of block 0): a staged stage's first copies and
// fetches, its waits for the chunks, its products, its sums and epilogue;
// an item's loads, conv and L; its tanh, energy sums, partials, arrival
// and the last item's reduction
enum SProf {
  SP_STAGE, SP_WAIT, SP_DOTS, SP_EPI, SP_LOC_LOAD, SP_LOC_CONV, SP_LOC_L, SP_E_TANH, SP_E_SUMS,
  SP_E_PART, SP_E_ARRIVE, SP_E_REDUCE
};

// floats at the head of the dynamic shared memory: the weights' mbarrier,
// then the workspace views (DWork)
constexpr int HEAD_FLOATS = 4 + 64;

struct DWork {  // views into ResArgs::work; every row 16-byte aligned
  int64_t Tp, Fp;
  float *ah, *ctx, *cum, *att, *h1, *c1, *h2, *c2, *mel;  // (2, B, .): ping-pong state
  float *p1, *p2, *q, *xin, *x1, *x2, *sig;               // (B, .)
  // the off-chain halves: the GRUCell's [r + z sums, n input, n hidden]
  // (B, 4, D) and the LSTMs' hidden products with their biases (B, 4L) x2
  float *ga, *g1, *g2;
  float *pdiv, *pctx;         // the items' partials: (B, nc), (B, nc, E)
  float *egl;                 // (B * nc, 16, D): location features not in smem
  unsigned* cnt;              // (B,) the items' arrivals, nc a group
  int* above;                 // (B,) the last group g + 1 with a mel not below the threshold
  u64* bar;
  int64_t size;
  __host__ __device__ DWork(float* w, const ResArgs& a, const DecPlan& p)
      : Tp(up4(a.T)), Fp(up4(a.r * a.n_mels)) {
    Take take{w};
    const int64_t B = a.B;
    ah = take(2 * B * a.D); ctx = take(2 * B * a.E); cum = take(2 * B * Tp);
    att = take(2 * B * Tp); h1 = take(2 * B * a.L); c1 = take(2 * B * a.L);
    h2 = take(2 * B * a.L); c2 = take(2 * B * a.L); mel = take(2 * B * Fp);
    p1 = take(B * a.P1); p2 = take(B * a.P2); q = take(B * a.D);
    xin = take(B * a.L); x1 = take(B * a.L); x2 = take(B * a.L); sig = take(B * Tp);
    ga = take(B * 4 * a.D); g1 = take(B * 4 * a.L); g2 = take(B * 4 * a.L);
    pdiv = take(B * p.nc); pctx = take(B * p.nc * a.E);
    egl = p.e_smem ? nullptr : take(B * p.nc * TC * a.D);
    cnt = reinterpret_cast<unsigned*>(take(B));
    above = reinterpret_cast<int*>(take(B));
    bar = reinterpret_cast<u64*>(take(4));
    size = take.size;
  }
};

static_assert(sizeof(DWork) <= (HEAD_FLOATS - 4) * sizeof(float), "DWork outgrew its room");

// Split barrier over the grid (res::Bar's protocol, as CUTLASS's grid
// barrier orders it): arrive() after a block's own stage work, wait()
// before the next stage reads. A monotonic counter, epoch e complete at e
// * n. The block's barrier then thread 0's release add publish the block's
// writes; thread 0's acquire loads then the block's barrier make every
// block's visible, with no full fence on either side.
struct DBar {
  u64* ctr;
  u64 n, epoch;
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    ++epoch;
    if (threadIdx.x == 0)
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(ctr) : "memory");
  }
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      unsigned spins = 0;
      while (res::ld_acquire(ctr) < epoch * n)
        if (++spins > res::SPIN_LIMIT) __trap();
    }
    __syncthreads();
  }
  __device__ __forceinline__ void sync() {
    arrive();
    wait();
  }
};

// Row b of a ping-pong buffer (2, B, w) at index i.
__device__ __forceinline__ float* pp(float* base, int64_t w, int i, int b, int B) {
  return base + ((int64_t)i * B + b) * w;
}

// A staged input segment: row b is p + b * ld (mode 0), or row b of the
// ping-pong buffer p (ld floats a row) at the row's committed index
// (mode 1) or at the other one (mode 2); w floats (a multiple of 4).
struct PSeg {
  const float* p;
  int ld, w, mode;
};

// res::mbar_wait with a bound: a copy that never lands traps, not hangs
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* mb, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(res::smem_u32(mb)), "r"(parity)
        : "memory");
    if (!done && ++spins > res::SPIN_LIMIT) __trap();
  } while (!done);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(res::smem_u32(dst)), "l"(src)
               : "memory");
}

// The staged chunk of a stage's input: columns [c0, c1) of its segments
// side by side, row stride kc (RT 8).
struct XChunk {
  const float* X;
  int kc, c0, c1;
};
// One row's input read in place through L2 (RT 1): the segments' rows.
struct XRow {
  const float* p0;
  const float* p1;
  int w0;
};

// Columns [c0, c1) of rows [r0, r0 + nr) of the segments s0 and s1 side by
// side (s1 past s0's w columns) into X (row stride kc), by 16-byte cp.async copies through L2 (other
// blocks wrote them in this launch), every copy in flight at once,
// committed as one group. All threads.
__device__ __forceinline__ void stage_chunk_pp(float* X, int kc, int r0, int nr, const PSeg& s0,
                                               const PSeg& s1, int c0, int c1, const int* s_ci,
                                               int B) {
  const int w4 = (c1 - c0) >> 2;
  for (int e = threadIdx.x; e < nr * w4; e += THREADS) {
    const int i = e / w4, k = e - i * w4, col = c0 + 4 * k, b = r0 + i;
    const bool second = col >= s0.w;   // s1 is s0 for one segment
    const PSeg sg = second ? s1 : s0;
    const float* row = sg.mode == 0 ? sg.p + (int64_t)b * sg.ld
                                    : pp(const_cast<float*>(sg.p), sg.ld,
                                         sg.mode == 1 ? s_ci[b] : s_ci[b] ^ 1, b, B);
    cp_async16(X + (size_t)i * kc + 4 * k, row + col - (second ? s0.w : 0));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A weight group's rows: resident (by the block's unit m, then gate) or in
// device memory (by the global unit j: gate g's row of unit j is g * units
// + j).
struct WRows {
  const float* base;
  int64_t gs, us;
  bool by_m;
  __device__ __forceinline__ const float* row(int m, int j) const {
    return base + (by_m ? (int64_t)m : (int64_t)j) * us;
  }
};

__device__ __forceinline__ WRows wrows(const float* smem, int64_t res, int64_t off,
                                       const float* w, int units, int ng, int cols) {
  if (res) return WRows{smem + off, cols, (int64_t)ng * cols, true};
  return WRows{w, (int64_t)units * cols, cols, false};
}

// acc[g][i] += sum_k w[g * gs + k] x_i[xoff + k] for k < n (lanes along k,
// 16-byte loads, every lane's k in increasing order: chunk by chunk the
// same sums); w in shared or device memory (read-only in the launch, so
// through L1). From a staged chunk, the k whose column lies in it, over the
// first nr rows of the tile; from one row in place, every k.
template <int NG, int RT>
__device__ __forceinline__ void rdots(float (&acc)[NG][RT], const float* w, int64_t gs, int n,
                                      int xoff, const XChunk& x, int nr) {
  int k = (threadIdx.x & 31) * 4;
  if (xoff + k < x.c0) k += (x.c0 - xoff - k + 127) / 128 * 128;
  const int kend = min(n, x.c1 - xoff);
#pragma unroll 1
  for (; k < kend; k += 128) {
    float4 wv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) wv[g] = *reinterpret_cast<const float4*>(w + g * gs + k);
    const float* xc = x.X + xoff + k - x.c0;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 xv = i < nr ? *reinterpret_cast<const float4*>(xc + (size_t)i * x.kc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[g][i] = fmaf(wv[g].x, xv.x, acc[g][i]);
        acc[g][i] = fmaf(wv[g].y, xv.y, acc[g][i]);
        acc[g][i] = fmaf(wv[g].z, xv.z, acc[g][i]);
        acc[g][i] = fmaf(wv[g].w, xv.w, acc[g][i]);
      }
    }
  }
}

template <int NG, int RT>
__device__ __forceinline__ void rdots(float (&acc)[NG][RT], const float* w, int64_t gs, int n,
                                      int xoff, const XRow& x, int) {
#pragma unroll 4
  for (int k = (threadIdx.x & 31) * 4; k < n; k += 128) {
    const int col = xoff + k;
    const float4 xv = __ldcg(reinterpret_cast<const float4*>(
        col < x.w0 ? x.p0 + col : x.p1 + (col - x.w0)));
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 wv = *reinterpret_cast<const float4*>(w + g * gs + k);
      acc[g][0] = fmaf(wv.x, xv.x, acc[g][0]);
      acc[g][0] = fmaf(wv.y, xv.y, acc[g][0]);
      acc[g][0] = fmaf(wv.z, xv.z, acc[g][0]);
      acc[g][0] = fmaf(wv.w, xv.w, acc[g][0]);
    }
  }
}

__device__ __forceinline__ void fma4(float& a, const float4 w, const float4 x) {
  a = fmaf(w.x, x.x, a);
  a = fmaf(w.y, x.y, a);
  a = fmaf(w.z, x.z, a);
  a = fmaf(w.w, x.w, a);
}

// The GRUCell's off-chain products into acc: [r, z] of the input product on
// ctx (E columns) plus the hidden product on ah (D columns), n of the input
// product, n of the hidden product; wi / wh gate 0's rows (gate strides
// gsi / gsh). Every sum in column order, from a chunk as from a row.
template <int RT>
__device__ __forceinline__ void gru_off_dots(float (&acc)[4][RT], const float* wi, int64_t gsi,
                                             const float* wh, int64_t gsh, int E, int D,
                                             const XChunk& x, int nr) {
  rdots<3, RT>(*reinterpret_cast<float(*)[3][RT]>(&acc[0]), wi, gsi, E, 0, x, nr);
  rdots<2, RT>(*reinterpret_cast<float(*)[2][RT]>(&acc[0]), wh, gsh, D, E, x, nr);
  rdots<1, RT>(*reinterpret_cast<float(*)[1][RT]>(&acc[3]), wh + 2 * gsh, 0, D, E, x, nr);
}

// the same from one row read in place: one pass over its E + D columns, so
// every load is in flight at once
template <int RT>
__device__ __forceinline__ void gru_off_dots(float (&acc)[4][RT], const float* wi, int64_t gsi,
                                             const float* wh, int64_t gsh, int E, int D,
                                             const XRow& x, int) {
#pragma unroll 4
  for (int k = (threadIdx.x & 31) * 4; k < E + D; k += 128) {
    const float4 xv = __ldcg(reinterpret_cast<const float4*>(k < x.w0 ? x.p0 + k
                                                                      : x.p1 + (k - x.w0)));
    const bool in = k < E;
    const float* w0 = in ? wi + k : wh + (k - E);
    const int64_t gs = in ? gsi : gsh;
    fma4(acc[0][0], *reinterpret_cast<const float4*>(w0), xv);
    fma4(acc[1][0], *reinterpret_cast<const float4*>(w0 + gs), xv);
    if (in)
      fma4(acc[2][0], *reinterpret_cast<const float4*>(w0 + 2 * gs), xv);
    else
      fma4(acc[3][0], *reinterpret_cast<const float4*>(w0 + 2 * gs), xv);
  }
}

// Every acc[g][i] summed over the warp; pickr(acc[g], lane) then gives
// row `lane`'s sum (lane < nr).
template <int NG, int RT>
__device__ __forceinline__ void reduce_r(float (&acc)[NG][RT]) {
  if constexpr (RT == RB) {
    res::reduce_rows<NG>(acc);
  } else {
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[g][i] = warp_sum(acc[g][i]);
  }
}

template <int RT>
__device__ __forceinline__ float pickr(const float (&a)[RT], int i) {
  if constexpr (RT == RB)
    return pick(a, i);
  else
    return a[0];
}

// A stage over `units` output units, its input the segments s0 and s1 side
// by side (s1 the same as s0 for a one-segment input). Block k owns units
// k, k + grid, ...; an item is (unit, tile of RT rows), NG x RT sums, one
// at a time a warp. fetch(j, first row, rows, pre) loads the lane's
// epilogue operands (NP floats) early; dots(acc, j, m, x, rows) adds the
// products over the input x; the sums are reduced and epi(acc, j, first
// row, rows, pre) runs on every lane.
// RT 1: a warp's item reads the row in place, no block barrier.
// RT 8: a pass takes as many rows as give every warp one item (at most
// p.rows), and its input is staged into two buffers of p.rows x p.kc
// floats a chunk at a time, the next chunk's copies in flight during this
// one's products; a pass of fewer rows takes proportionally wider chunks.
template <int RT, int NG, int NP, typename Fetch, typename Dots, typename Epi>
__device__ __forceinline__ void mstage(const DecPlan& p, float* X, const int* s_ci, int B,
                                       int units, const PSeg s0, const PSeg s1, Prof& ps,
                                       Fetch&& fetch, Dots&& dots, Epi&& epi) {
  const int nblk = (int)p.nblk;
  if ((int)blockIdx.x >= units) return;  // block-uniform
  ps.start(ps.out);
  const int mine = (units - 1 - (int)blockIdx.x) / nblk + 1;
  const int warp = threadIdx.x >> 5;
  if constexpr (RT == 1) {
    auto rowp = [&](const PSeg& sg) {
      return sg.mode == 0 ? sg.p : pp(const_cast<float*>(sg.p), sg.ld,
                                      sg.mode == 1 ? s_ci[0] : s_ci[0] ^ 1, 0, B);
    };
    const XRow x{rowp(s0), rowp(s1), s0.w};
    for (int m = warp; m < mine; m += WARPS) {
      const int j = (int)blockIdx.x + m * nblk;
      float pre[NP];
      fetch(j, 0, 1, pre);
      float acc[NG][1];
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[g][0] = 0.f;
      dots(acc, j, m, x, 1);
      ps.stamp(SP_DOTS);
      reduce_r<NG, 1>(acc);
      epi(acc, j, 0, 1, pre);
      ps.stamp(SP_EPI);
    }
  } else {
    const int xs = s0.w + (s1.p == s0.p ? 0 : s1.w);
    const int rows = min((int)p.rows, max(1, WARPS / mine) * RT);
    const int kc = min((int)(p.rows * p.kc / rows) / 128 * 128, (xs + 127) / 128 * 128);
    const int nch = (xs + kc - 1) / kc;
    const size_t buf = (size_t)p.rows * p.kc;
    for (int r0 = 0; r0 < B; r0 += rows) {
      const int nrp = min(rows, B - r0), tiles = (nrp + RT - 1) / RT, nitems = mine * tiles;
      for (int ib = 0; ib < nitems; ib += WARPS) {
        const int it = ib + warp, tile = it / mine, m = it - tile * mine;
        const int j = (int)blockIdx.x + m * nblk, b0 = r0 + tile * RT;
        const int nr = min(RT, nrp - tile * RT);
        const bool mine_it = it < nitems;
        float acc[NG][RT], pre[NP];
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[g][i] = 0.f;
        __syncthreads();   // both buffers are free
        stage_chunk_pp(X, kc, r0, nrp, s0, s1, 0, min(kc, xs), s_ci, B);
        if (mine_it) fetch(j, b0, nr, pre);
        ps.stamp(SP_STAGE);
        for (int c = 0; c < nch; ++c) {
          const int c0 = c * kc, c1 = min(c0 + kc, xs);
          if (c + 1 < nch) {
            stage_chunk_pp(X + ((c + 1) & 1) * buf, kc, r0, nrp, s0, s1, c1, min(c1 + kc, xs),
                           s_ci, B);
            asm volatile("cp.async.wait_group 1;" ::: "memory");
          } else {
            asm volatile("cp.async.wait_group 0;" ::: "memory");
          }
          __syncthreads();   // chunk c has landed for every thread
          ps.stamp(SP_WAIT);
          if (mine_it)
            dots(acc, j, m, XChunk{X + (c & 1) * buf + (size_t)tile * RT * kc, kc, c0, c1}, nr);
          __syncthreads();   // every warp is done with chunk c's buffer
          ps.stamp(SP_DOTS);
        }
        if (mine_it) {
          reduce_r<NG, RT>(acc);
          epi(acc, j, b0, nr, pre);
        }
        ps.stamp(SP_EPI);
      }
    }
  }
}

// u[tt] = sum_d v[d] arg[tt] over the block's units for tt < ti, as
// taco_train.cu's lsa_u (the same sums), inlined: a warp sum per position,
// then the warps' partials (red16, WARPS x TC) in a fixed order into u. All
// threads.
__device__ __forceinline__ void energies(const float (&arg)[TC], int ti, float vd, float* red16,
                                         float* u) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) {
    if (tt < ti) {
      const float p = warp_sum(vd * arg[tt]);
      if (lane == 0) red16[warp * TC + tt] = p;
    }
  }
  __syncthreads();
  if (threadIdx.x < ti) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += red16[w * TC + threadIdx.x];
    u[threadIdx.x] = acc;
  }
  __syncthreads();
}

// The location features of item (b, c) for the group entering with the
// row's state at index ci: e[tt][d] = encp[b, t0 + tt, d] + sum_f L[d, f]
// conv([cum; att])[f, t0 + tt] (0 past the row's T). The conv as the
// original body sums it (per tap k the cumulative's, then the attention's
// term), L over the channels in order. All threads.
__device__ __forceinline__ void item_loc(const ResArgs& a, const DWork& w, float* sc,
                                         const float* s_conv, float* e, int b, int c, int ci,
                                         int ti, Prof& ps) {
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D;
  const int t0 = c * ti, tc = min(ti, T - t0);
  ps.start(ps.out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* cw = sc;
  float* aw = sc + WINP;
  float* loc = sc + ATT_LOC;
  // thread d's column of L and its encp values, loaded while the windows land
  float lw[LOC_CH], en[TC];
  const int d0 = threadIdx.x;
  const float* ep = a.encp + ((size_t)b * T + t0) * D + d0;
#pragma unroll
  for (int f = 0; f < LOC_CH; ++f) lw[f] = d0 < D ? __ldg(a.lwt + f * D + d0) : 0.f;
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) en[tt] = d0 < D && tt < tc ? __ldg(ep + (size_t)tt * D) : 0.f;
  __syncthreads();   // earlier users of the scratch are done
  if (threadIdx.x < WINP) {
    const int j = threadIdx.x, t = t0 - CONV_HALF + j;
    const bool in = j < ti + 2 * CONV_HALF && t >= 0 && t < T;
    cw[j] = in ? __ldcg(pp(w.cum, w.Tp, ci, b, B) + t) : 0.f;
    aw[j] = in ? __ldcg(pp(w.att, w.Tp, ci, b, B) + t) : 0.f;
  }
  __syncthreads();
  ps.stamp(SP_LOC_LOAD);
  for (int tt = warp; tt < ti; tt += WARPS) {   // lane = channel
    const float* cf = s_conv + lane * 2 * CONV_K;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CONV_K; ++k) {
      s = fmaf(cf[k], cw[tt + k], s);
      s = fmaf(cf[CONV_K + k], aw[tt + k], s);
    }
    loc[tt * LOC_CH + lane] = s;
  }
  __syncthreads();
  ps.stamp(SP_LOC_CONV);
  if (d0 < D) {   // D <= THREADS (the wrapper's check)
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (tt >= ti) break;
      const float4* lc = reinterpret_cast<const float4*>(loc + tt * LOC_CH);
      float ll = 0.f;
#pragma unroll
      for (int f4 = 0; f4 < LOC_CH / 4; ++f4) {
        const float4 l4 = lc[f4];
        ll = fmaf(l4.x, lw[4 * f4], ll);
        ll = fmaf(l4.y, lw[4 * f4 + 1], ll);
        ll = fmaf(l4.z, lw[4 * f4 + 2], ll);
        ll = fmaf(l4.w, lw[4 * f4 + 3], ll);
      }
      e[tt * D + d0] = tt < tc ? en[tt] + ll : 0.f;
    }
  }
  ps.stamp(SP_LOC_L);
}

// sum_q src[q * stride] for q < n in order, sixteen loads in flight (other
// blocks wrote them: through L2)
__device__ __forceinline__ float ordered_sum16(const float* src, int n, int64_t stride) {
  float s = 0.f;
  for (int q0 = 0; q0 < n; q0 += 16) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = q0 + q < n ? __ldcg(src + (q0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (q0 + q < n) s += v[q];
  }
  return s;
}

// Item (b, c)'s energies at group g: u_t = v . tanh(q + e_t), sig_t =
// sigmoid(u_t) mask_t, their partial sum to pdiv and the partial context
// sum_t sig_t enc_t to pctx. e is this block's (written in slack 2 by these
// threads, so plain loads see it, in shared or device memory). The row's
// last item to arrive at its count sums the partials in item order: the
// normaliser, the context of the group's new state, the scores (the
// group's attention output) and the cumulative. All threads.
__device__ __forceinline__ void item_energies(const ResArgs& a, const DWork& w, float* sc,
                                              const float* s_v, const float* e, int b, int c,
                                              int nc, int ti, int g, int ci, Prof& ps) {
  const int B = (int)a.B, T = (int)a.T, D = (int)a.D, E = (int)a.E, G = (int)a.n_groups;
  const int t0 = c * ti, tc = min(ti, T - t0);
  ps.start(ps.out);
  float* red16 = sc + ATT_RED;
  float* su = sc + ATT_U;
  float* misc = sc + ATT_MISC;
  const int d = threadIdx.x;
  const bool unit = d < D;
  // the loads that do not wait for the query first
  const float mk = threadIdx.x < tc ? a.mask[(size_t)b * T + t0 + threadIdx.x] : 0.f;
  float ev[TC];
  const float* er = a.enc + ((size_t)b * T + t0) * E + threadIdx.x;
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) ev[tt] = threadIdx.x < E && tt < tc ? __ldg(er + (size_t)tt * E) : 0.f;
  const float vd = unit ? s_v[d] : 0.f;
  const float qd = unit ? __ldcg(w.q + (size_t)b * D + d) : 0.f;
  float arg[TC];
#pragma unroll
  for (int tt = 0; tt < TC; ++tt) arg[tt] = unit && tt < tc ? tanhf(qd + e[tt * D + d]) : 0.f;
  ps.stamp(SP_E_TANH);
  energies(arg, ti, vd, red16, su);
  ps.stamp(SP_E_SUMS);
  if (threadIdx.x < tc) {
    const float sg = sigm(su[threadIdx.x]) * mk;
    w.sig[(size_t)b * w.Tp + t0 + threadIdx.x] = sg;
    su[threadIdx.x] = sg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int tt = 0; tt < tc; ++tt) s += su[tt];
    w.pdiv[(size_t)b * nc + c] = s;
  }
  for (int k = threadIdx.x; k < E; k += THREADS) {
    float s = 0.f;
    if (k < THREADS) {
#pragma unroll
      for (int tt = 0; tt < TC; ++tt)
        if (tt < tc) s = fmaf(su[tt], ev[tt], s);
    } else {
      for (int tt = 0; tt < tc; ++tt) s = fmaf(su[tt], __ldg(er + (size_t)tt * E + k - threadIdx.x), s);
    }
    w.pctx[((size_t)b * nc + c) * E + k] = s;
  }
  // arrival at the row's count: the last of its nc items of group g sums
  __syncthreads();
  ps.stamp(SP_E_PART);
  if (threadIdx.x == 0) {
    // acq_rel: publishes the block's partials, and the last arrival sees
    // every other item's
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(w.cnt + b)
                 : "memory");
    const bool last = old == (unsigned)((g + 1) * nc - 1);
    misc[0] = last ? 1.f : 0.f;
  }
  __syncthreads();
  ps.stamp(SP_E_ARRIVE);
  if (misc[0] == 0.f) return;
  const int ni = ci ^ 1;
  // every load of the reduction in flight at once: the context's column
  // (unnormalised), the scores' and the cumulative's first positions, the
  // normaliser
  const int k0 = threadIdx.x;
  const float cx = k0 < E ? ordered_sum16(w.pctx + (size_t)b * nc * E + k0, nc, E) : 0.f;
  const float sg0 = k0 < T ? __ldcg(w.sig + (size_t)b * w.Tp + k0) : 0.f;
  const float cu0 = k0 < T ? __ldcg(pp(w.cum, w.Tp, ci, b, B) + k0) : 0.f;
  if (threadIdx.x == 0) {
    const float s = ordered_sum16(w.pdiv + (size_t)b * nc, nc, 1);
    misc[1] = s > 0.f ? s : 1.f;
  }
  __syncthreads();
  const float tot = misc[1];
  for (int k = k0; k < E; k += THREADS)
    pp(w.ctx, E, ni, b, B)[k] =
        (k == k0 ? cx : ordered_sum16(w.pctx + (size_t)b * nc * E + k, nc, E)) / tot;
  for (int t = k0; t < T; t += THREADS) {
    const float at = (t == k0 ? sg0 : __ldcg(w.sig + (size_t)b * w.Tp + t)) / tot;
    pp(w.att, w.Tp, ni, b, B)[t] = at;
    pp(w.cum, w.Tp, ni, b, B)[t] = (t == k0 ? cu0 : __ldcg(pp(w.cum, w.Tp, ci, b, B) + t)) + at;
    a.att_out[((size_t)b * G + g) * T + t] = at;
  }
  ps.stamp(SP_E_REDUCE);
}

template <int RT, bool PROF>
__device__ __forceinline__ void decode_body(const ResArgs& a, const DecPlan& p) {
  const int B = (int)a.B, T = (int)a.T, E = (int)a.E, D = (int)a.D;
  const int P1 = (int)a.P1, P2 = (int)a.P2, L = (int)a.L, NM = (int)a.n_mels;
  const int r = (int)a.r, F = r * NM, G = (int)a.n_groups;
  const int nblk = (int)p.nblk, nc = (int)p.nc, ipb = (int)p.ipb, ti = (int)p.ti;
  const float thr = (float)a.stop_threshold;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float smem[];
  // the workspace views sit in shared memory (read where used, not held in
  // registers across the loop)
  DWork* s_wk = reinterpret_cast<DWork*>(smem + 4);
  if (threadIdx.x == 0) *s_wk = DWork(a.work, a, p);
  __syncthreads();
  const DWork& wk = *s_wk;
  const int64_t Fp = wk.Fp;
  DBar bar{wk.bar, (u64)nblk, 0};
  Prof pf, ps;   // the group's stages; the split inside them
  pf.start(PROF ? a.prof : nullptr);
  ps.start(PROF ? a.prof + DP_N : nullptr);

  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  float* X = smem + p.off_x;
  float* s_conv = smem + p.off_conv;
  float* s_v = smem + p.off_v;
  float* s_att = smem + p.off_att;
  int* s_ci = reinterpret_cast<int*>(smem + p.off_rows);   // committed ping-pong index
  int* s_stop = s_ci + B;                                  // stopped before this group
  int* s_valid = s_stop + B;                               // groups decoded live
  int* s_hit = s_valid + B;                                // this group's stop test
  int* s_nb = s_hit + B;   // the block's mels of the row: one not below the threshold
  float* s_e = smem + p.off_e;

  // the weight groups: (resident rows or device memory) by units
  const WRows Wfc1 = wrows(smem, p.res_fc1, p.off_fc1, a.w1p, P1, 1, NM);
  const WRows Wfc2 = wrows(smem, p.res_fc2, p.off_fc2, a.w2p, P2, 1, P1);
  const WRows Wawi = wrows(smem, p.res_awi, p.off_awi, a.awi, D, 3, E + P2);
  const WRows Wawh = wrows(smem, p.res_awh, p.off_awh, a.awh, D, 3, D);
  const WRows Wq = wrows(smem, p.res_wq, p.off_wq, a.wq, D, 1, D);
  const WRows Wr = wrows(smem, p.res_wr, p.off_wr, a.wr, L, 1, E + D);
  const WRows W1i = wrows(smem, p.res_l1wi, p.off_l1wi, a.l1wi, L, 4, L);
  const WRows W1h = wrows(smem, p.res_l1wh, p.off_l1wh, a.l1wh, L, 4, L);
  const WRows W2i = wrows(smem, p.res_l2wi, p.off_l2wi, a.l2wi, L, 4, L);
  const WRows W2h = wrows(smem, p.res_l2wh, p.off_l2wh, a.l2wh, L, 4, L);
  const WRows Wm = wrows(smem, p.res_wm, p.off_wm, a.wm, F, 1, L);

  // ---- prologue: the resident rows by one bulk copy each onto the
  // mbarrier; the attention's weights ----
  for (int b = threadIdx.x; b < B; b += THREADS) {
    s_ci[b] = 0;
    s_stop[b] = 0;
    s_valid[b] = 0;
    s_nb[b] = 0;
  }
  if (threadIdx.x == 0) {
    res::mbar_init(mbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    struct Grp {
      int64_t res, off;
      const float* w;
      int units, ng, cols;
    };
    const Grp gs[11] = {{p.res_fc1, p.off_fc1, a.w1p, P1, 1, NM},
                        {p.res_fc2, p.off_fc2, a.w2p, P2, 1, P1},
                        {p.res_awi, p.off_awi, a.awi, D, 3, E + P2},
                        {p.res_awh, p.off_awh, a.awh, D, 3, D},
                        {p.res_wq, p.off_wq, a.wq, D, 1, D},
                        {p.res_wr, p.off_wr, a.wr, L, 1, E + D},
                        {p.res_l1wi, p.off_l1wi, a.l1wi, L, 4, L},
                        {p.res_l1wh, p.off_l1wh, a.l1wh, L, 4, L},
                        {p.res_l2wi, p.off_l2wi, a.l2wi, L, 4, L},
                        {p.res_l2wh, p.off_l2wh, a.l2wh, L, 4, L},
                        {p.res_wm, p.off_wm, a.wm, F, 1, L}};
    uint32_t res_bytes = 0;
#pragma unroll
    for (int k = 0; k < 11; ++k) {
      if (!gs[k].res || (int)blockIdx.x >= gs[k].units) continue;
      const int mine = (gs[k].units - 1 - (int)blockIdx.x) / nblk + 1;
      res_bytes += (uint32_t)(mine * gs[k].ng * gs[k].cols * 4);
    }
    if (res_bytes) {
      res::mbar_expect_tx(mbar, res_bytes);
#pragma unroll
      for (int k = 0; k < 11; ++k) {
        if (!gs[k].res || (int)blockIdx.x >= gs[k].units) continue;
        const int mine = (gs[k].units - 1 - (int)blockIdx.x) / nblk + 1;
        const uint32_t bytes = (uint32_t)gs[k].cols * 4;
        for (int m = 0; m < mine; ++m) {
          const int j = (int)blockIdx.x + m * nblk;
          for (int g = 0; g < gs[k].ng; ++g)
            res::bulk_g2s(smem + gs[k].off + ((int64_t)m * gs[k].ng + g) * gs[k].cols,
                          gs[k].w + ((int64_t)g * gs[k].units + j) * gs[k].cols, bytes, mbar);
        }
      }
    }
    s_hit[0] = res_bytes != 0;   // tells the block whether to wait
  }
  for (int e = threadIdx.x; e < LOC_CH * 2 * CONV_K; e += THREADS) s_conv[e] = a.conv[e];
  for (int e = threadIdx.x; e < D; e += THREADS) s_v[e] = a.v[e];
  __syncthreads();
  if (s_hit[0]) mbar_wait_bounded(mbar, 0);
  __syncthreads();
  bar.sync();
  pf.stamp(DP_PRO);

  // this block's attention items: m-th is item blockIdx + m * grid
  auto items = [&](auto&& fn) {
    for (int m = 0; m < ipb; ++m) {
      const int it = (int)blockIdx.x + m * nblk;
      if (it >= B * nc) break;
      fn(m, it / nc, it % nc);
    }
  };
  auto e_of = [&](int m, int b, int c) {
    return p.e_smem ? s_e + (size_t)m * TC * D : wk.egl + ((size_t)b * nc + c) * TC * D;
  };
  auto no_fetch = [&](int, int, int, float(&)[1]) {};
  auto bias_fetch = [&](const float* bias) {
    return [=](int j, int, int, float(&pre)[1]) { pre[0] = bias[j]; };
  };
  // the LSTMs' hidden halves with their biases, from the state entering the group
  auto lstm_h = [&](int layer) {
    const WRows& Wh = layer == 0 ? W1h : W2h;
    float* gout = layer == 0 ? wk.g1 : wk.g2;
    const float* bias = layer == 0 ? a.l1b : a.l2b;
    const PSeg sg0 = {layer == 0 ? wk.h1 : wk.h2, L, L, 1};
    mstage<RT, 4, 4>(
        p, X, s_ci, B, L, sg0, sg0, ps,
        [&](int j, int, int, float(&pre)[4]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) pre[q] = bias[q * L + j];
        },
        [&](auto& acc, int j, int m, const auto& x, int nr) {
          rdots<4, RT>(acc, Wh.row(m, j), Wh.gs, L, 0, x, nr);
        },
        [&](float(&acc)[4][RT], int j, int b0, int nr, const float(&pre)[4]) {
          if (lane < nr) {
            float* o = gout + (size_t)(b0 + lane) * 4 * L;
#pragma unroll
            for (int q = 0; q < 4; ++q) o[q * L + j] = pickr<RT>(acc[q], lane) + pre[q];
          }
        });
  };
  // a residual LSTMCell's input half, its cell and x_out = x_in + h
  auto lstm_x = [&](int layer) {
    const WRows& Wi = layer == 0 ? W1i : W2i;
    const float* gin = layer == 0 ? wk.g1 : wk.g2;
    const float* xin = layer == 0 ? wk.xin : wk.x1;
    float* xout = layer == 0 ? wk.x1 : wk.x2;
    float* hb = layer == 0 ? wk.h1 : wk.h2;
    float* cb = layer == 0 ? wk.c1 : wk.c2;
    const PSeg sg0 = {xin, L, L, 0};
    mstage<RT, 4, 6>(
        p, X, s_ci, B, L, sg0, sg0, ps,
        [&](int j, int b0, int nr, float(&pre)[6]) {
          if (lane < nr) {
            const int b = b0 + lane;
            const float* gh = gin + (size_t)b * 4 * L + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) pre[q] = __ldcg(gh + q * L);
            pre[4] = __ldcg(pp(cb, L, s_ci[b], b, B) + j);
            pre[5] = __ldcg(xin + (size_t)b * L + j);
          }
        },
        [&](auto& acc, int j, int m, const auto& x, int nr) {
          rdots<4, RT>(acc, Wi.row(m, j), Wi.gs, L, 0, x, nr);
        },
        [&](float(&acc)[4][RT], int j, int b0, int nr, const float(&pre)[6]) {
          if (lane < nr) {
            const int b = b0 + lane, ni = s_ci[b] ^ 1;
            const float ig = sigm(pickr<RT>(acc[0], lane) + pre[0]);
            const float fg = sigm(pickr<RT>(acc[1], lane) + pre[1]);
            const float gg = tanhf(pickr<RT>(acc[2], lane) + pre[2]);
            const float og = sigm(pickr<RT>(acc[3], lane) + pre[3]);
            const float c = fg * pre[4] + ig * gg;
            const float h = og * tanhf(c);
            pp(cb, L, ni, b, B)[j] = c;
            pp(hb, L, ni, b, B)[j] = h;
            xout[(size_t)b * L + j] = pre[5] + h;
          }
        });
  };

  for (int g = 0; g < G; ++g) {
    bool all_frozen = true;
    for (int b = 0; b < B; ++b) all_frozen &= s_stop[b] != 0;
    // ---- 1: prenet fc1 on each row's last frame ----
    {
      const PSeg sg0 = {wk.mel + (r - 1) * NM, (int)Fp, NM, 1};
      mstage<RT, 1, 1>(
          p, X, s_ci, B, P1, sg0, sg0, ps, bias_fetch(a.b1p),
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            rdots<1, RT>(acc, Wfc1.row(m, j), 0, NM, 0, x, nr);
          },
          [&](float(&acc)[1][RT], int j, int b0, int nr, const float(&pre)[1]) {
            if (lane < nr)
              wk.p1[(size_t)(b0 + lane) * P1 + j] = fmaxf(pickr<RT>(acc[0], lane) + pre[0], 0.f);
          });
    }
    pf.stamp(DP_FC1);
    bar.arrive();
    // slack 1: the GRUCell's ctx half of the input product and its hidden
    // product, with their biases: [r and z: both summed, n: input, n: hidden]
    {
      const PSeg sg0 = {wk.ctx, E, E, 1}, sg1 = {wk.ah, D, D, 1};
      mstage<RT, 4, 4>(
          p, X, s_ci, B, D, sg0, sg1, ps,
          [&](int j, int, int, float(&pre)[4]) {
            pre[0] = a.abi[j] + a.abh[j];
            pre[1] = a.abi[D + j] + a.abh[D + j];
            pre[2] = a.abi[2 * D + j];
            pre[3] = a.abh[2 * D + j];
          },
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            gru_off_dots<RT>(acc, Wawi.row(m, j), Wawi.gs, Wawh.row(m, j), Wawh.gs, E, D, x, nr);
          },
          [&](float(&acc)[4][RT], int j, int b0, int nr, const float(&pre)[4]) {
            if (lane < nr) {
              float* o = wk.ga + (size_t)(b0 + lane) * 4 * D + j;
#pragma unroll
              for (int q = 0; q < 4; ++q) o[q * D] = pickr<RT>(acc[q], lane) + pre[q];
            }
          });
    }
    pf.stamp(DP_FC1_S);
    bar.wait();
    pf.stamp(DP_FC1_W);
    // ---- 2: prenet fc2 ----
    {
      const PSeg sg0 = {wk.p1, P1, P1, 0};
      mstage<RT, 1, 1>(
          p, X, s_ci, B, P2, sg0, sg0, ps, bias_fetch(a.b2p),
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            rdots<1, RT>(acc, Wfc2.row(m, j), 0, P1, 0, x, nr);
          },
          [&](float(&acc)[1][RT], int j, int b0, int nr, const float(&pre)[1]) {
            if (lane < nr)
              wk.p2[(size_t)(b0 + lane) * P2 + j] = fmaxf(pickr<RT>(acc[0], lane) + pre[0], 0.f);
          });
    }
    pf.stamp(DP_FC2);
    bar.arrive();
    // slack 2: the location features of this block's items
    items([&](int m, int b, int c) {
      item_loc(a, wk, s_att, s_conv, e_of(m, b, c), b, c, s_ci[b], ti, ps);
    });
    pf.stamp(DP_FC2_S);
    bar.wait();
    pf.stamp(DP_FC2_W);
    // ---- 3: the GRUCell: its p half, then the cell ----
    {
      const PSeg sg0 = {wk.p2, P2, P2, 0};
      mstage<RT, 3, 5>(
          p, X, s_ci, B, D, sg0, sg0, ps,
          [&](int j, int b0, int nr, float(&pre)[5]) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float* ga = wk.ga + (size_t)b * 4 * D + j;
#pragma unroll
              for (int q = 0; q < 4; ++q) pre[q] = __ldcg(ga + q * D);
              pre[4] = __ldcg(pp(wk.ah, D, s_ci[b], b, B) + j);
            }
          },
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            rdots<3, RT>(acc, Wawi.row(m, j) + E, Wawi.gs, P2, 0, x, nr);
          },
          [&](float(&acc)[3][RT], int j, int b0, int nr, const float(&pre)[5]) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float rr = sigm(pre[0] + pickr<RT>(acc[0], lane));
              const float z = sigm(pre[1] + pickr<RT>(acc[1], lane));
              const float n = tanhf((pre[2] + pickr<RT>(acc[2], lane)) + rr * pre[3]);
              pp(wk.ah, D, s_ci[b] ^ 1, b, B)[j] = (1.f - z) * n + z * pre[4];
            }
          });
    }
    pf.stamp(DP_GRU);
    bar.arrive();
    lstm_h(0);   // slack 3
    pf.stamp(DP_GRU_S);
    bar.wait();
    pf.stamp(DP_GRU_W);
    // ---- 4: the query W ah + W.b + L.b ----
    {
      const PSeg sg0 = {wk.ah, D, D, 2};
      mstage<RT, 1, 1>(
          p, X, s_ci, B, D, sg0, sg0, ps, bias_fetch(a.qb),
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            rdots<1, RT>(acc, Wq.row(m, j), 0, D, 0, x, nr);
          },
          [&](float(&acc)[1][RT], int j, int b0, int nr, const float(&pre)[1]) {
            if (lane < nr) wk.q[(size_t)(b0 + lane) * D + j] = pickr<RT>(acc[0], lane) + pre[0];
          });
    }
    pf.stamp(DP_Q);
    bar.arrive();
    lstm_h(1);   // slack 4
    pf.stamp(DP_Q_S);
    bar.wait();
    pf.stamp(DP_Q_W);
    // ---- 5: the energies of this block's items; each row's last item
    // forms the normaliser, the context, the scores and the cumulative ----
    items([&](int m, int b, int c) {
      __syncthreads();   // the scratch's earlier users are done
      item_energies(a, wk, s_att, s_v, e_of(m, b, c), b, c, nc, ti, g, s_ci[b], ps);
    });
    pf.stamp(DP_ITEMS);
    bar.arrive();
    pf.stamp(DP_ITEMS_S);
    bar.wait();
    pf.stamp(DP_ITEMS_W);
    // ---- 6: rnn_input on [ctx | ah] ----
    {
      const PSeg sg0 = {wk.ctx, E, E, 2}, sg1 = {wk.ah, D, D, 2};
      mstage<RT, 1, 1>(
          p, X, s_ci, B, L, sg0, sg1, ps, bias_fetch(a.br),
          [&](auto& acc, int j, int m, const auto& x, int nr) {
            rdots<1, RT>(acc, Wr.row(m, j), 0, E + D, 0, x, nr);
          },
          [&](float(&acc)[1][RT], int j, int b0, int nr, const float(&pre)[1]) {
            if (lane < nr) wk.xin[(size_t)(b0 + lane) * L + j] = pickr<RT>(acc[0], lane) + pre[0];
          });
    }
    pf.stamp(DP_RNN);
    bar.arrive();
    pf.stamp(DP_RNN_S);
    bar.wait();
    pf.stamp(DP_RNN_W);
    // ---- 7, 8: the residual LSTMCells' input halves and cells ----
    lstm_x(0);
    pf.stamp(DP_L1);
    bar.arrive();
    pf.stamp(DP_L1_S);
    bar.wait();
    pf.stamp(DP_L1_W);
    lstm_x(1);
    pf.stamp(DP_L2);
    bar.arrive();
    pf.stamp(DP_L2_S);
    bar.wait();
    pf.stamp(DP_L2_W);
    // ---- 9: mel_proj, the r frames, to the state and the output ----
    {
      const PSeg sg0 = {wk.x2, L, L, 0};
      mstage<RT, 1, 1>(
          p, X, s_ci, B, F, sg0, sg0, ps, no_fetch,
          [&](auto& acc, int f, int m, const auto& x, int nr) {
            rdots<1, RT>(acc, Wm.row(m, f), 0, L, 0, x, nr);
          },
          [&](float(&acc)[1][RT], int f, int b0, int nr, const float(&)[1]) {
            if (lane < nr) {
              const int b = b0 + lane;
              const float mv = pickr<RT>(acc[0], lane);
              pp(wk.mel, Fp, s_ci[b] ^ 1, b, B)[f] = mv;
              a.mel_out[((size_t)b * G + g) * F + f] = mv;
              if (!(mv < thr)) s_nb[b] = 1;
            }
          });
      // one flag a row for the block's units: the group's number where a
      // value is not below the threshold
      __syncthreads();
      for (int b = threadIdx.x; b < B; b += THREADS)
        if (s_nb[b]) {
          atomicMax(wk.above + b, g + 1);
          s_nb[b] = 0;
        }
    }
    pf.stamp(DP_MEL);
    bar.arrive();
    pf.stamp(DP_MEL_S);
    bar.wait();
    pf.stamp(DP_MEL_W);
    // ---- per-row stop test, commit or freeze (every block, same answer):
    // the row's mels were all below the threshold where no block flagged
    // this group ----
    for (int b = threadIdx.x; b < B; b += THREADS) s_hit[b] = __ldcg(wk.above + b) == g + 1;
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += THREADS) {
      if (!s_stop[b]) {
        ++s_valid[b];
        s_stop[b] = !s_hit[b] && g * r > 10;
        s_ci[b] ^= 1;   // commit the row's new state
      }
    }
    __syncthreads();
    pf.stamp(DP_STOP);
    if (all_frozen) {
      // every row was frozen: this group's output is every later group's
      const int rest = G - 1 - g, per = F + T;
      for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < (int64_t)B * rest * per;
           i += (int64_t)nblk * THREADS) {
        const int b = (int)(i / ((int64_t)rest * per));
        const int64_t k = i - (int64_t)b * rest * per;
        const int g2 = g + 1 + (int)(k / per), e = (int)(k % per);
        if (e < F)
          a.mel_out[((size_t)b * G + g2) * F + e] = __ldcg(a.mel_out + ((size_t)b * G + g) * F + e);
        else
          a.att_out[((size_t)b * G + g2) * T + e - F] =
              __ldcg(a.att_out + ((size_t)b * G + g) * T + e - F);
      }
      break;
    }
  }
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < B; b += THREADS) a.n_valid[b] = s_valid[b];
}

}  // namespace decres


__global__ void __launch_bounds__(THREADS, 1) taco_dec_res_r1(ResArgs a, DecPlan p) {
  decres::decode_body<1, false>(a, p);
}
__global__ void __launch_bounds__(THREADS, 1) taco_dec_res_r8(ResArgs a, DecPlan p) {
  decres::decode_body<8, false>(a, p);
}
__global__ void __launch_bounds__(THREADS, 1) taco_dec_res_r1_prof(ResArgs a, DecPlan p) {
  decres::decode_body<1, true>(a, p);
}
__global__ void __launch_bounds__(THREADS, 1) taco_dec_res_r8_prof(ResArgs a, DecPlan p) {
  decres::decode_body<8, true>(a, p);
}

extern "C" {

// Floats of workspace a launch needs (zero-filled by the caller).
int64_t wr_taco_dec_res_work_floats(const ResArgs* args, const DecPlan* plan) {
  return decres::DWork(nullptr, *args, *plan).size;
}

// Launches the decode on `stream` (the instantiation of plan->rt rows a
// tile, the profiling one where args->prof is set); returns the CUDA error
// code (0 = launched).
int wr_taco_dec_res(const ResArgs* args, const DecPlan* plan, void* stream) {
  ResArgs a = *args;
  DecPlan p = *plan;
  const void* fn = p.rt == 1 ? (a.prof ? (const void*)taco_dec_res_r1_prof
                                       : (const void*)taco_dec_res_r1)
                             : (a.prof ? (const void*)taco_dec_res_r8_prof
                                       : (const void*)taco_dec_res_r8);
  if (p.rt != 1 && p.rt != 8) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (p.nblk > sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem_bytes);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, (size_t)p.smem_bytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a, &p};
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)p.nblk), dim3(THREADS), kargs,
                                  (size_t)p.smem_bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
