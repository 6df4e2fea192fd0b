// Radius-gated Hamming nearest / second-nearest neighbour for packed
// 256-bit binary descriptors, for Hopper (sm_90a).
//
// Replaces the TPU kernel monocular_visual_odometry_tpu/ops/pallas/hamming.py
// (hamming_nn_top2, body _kernel): for every query descriptor, over all train
// descriptors that lie within radius r of EITHER query position (uv1 or
// uv1_alt) and are valid on both sides, the smallest Hamming distance, the
// second smallest (a duplicate of the smallest counts), and the lowest train
// index reaching the smallest. Queries with no such train point keep the
// 1e9 sentinels and index 0.
//
// The TPU kernel unpacks descriptors to +/-1 only to reach the matrix unit.
// Here a distance is 8 x (XOR + __popc) over 32-bit words of the packed
// [K, 32] uint8 rows, so the inputs are ~100 KB per call and the work is
// K1*K2 gate tests plus 8 popcounts for each pair that passes the gate.
//
// What bounds it on this card: neither the popcounts (~2 us for 1024 x 1024
// with every pair gated in, well under 1 us at the main path's 4-10% gated
// share) nor the bytes (~100 KB at 3.35 TB/s, ~30 ns). At the main path's
// shapes (~1k x 1k, one call per stage) it is latency: the launch, the round
// trip that brings the train set from L2 in front of the lanes, then the
// dependent steps of a scan that is short per SM. The first version (one warp
// per query, 8 per block, the train set walked in tiles of 256 points, each a
// plain global->shared copy between two __syncthreads) took 0.0106-0.0109 ms
// per call on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 1): four exposed
// load round trips and eight block barriers per call, nothing overlapped.
//
// Design:
// - The train set goes to dynamic shared memory in stages of kStage = 1024
//   points (41 KB: descriptors, positions, validity), each stage by three
//   1-D bulk async copies (cp.async.bulk, no tensor map) that one thread
//   issues onto mbarriers. Positions+validity complete on their own barrier,
//   so the radius gate starts while the 32 KB of descriptors is in flight;
//   the query's descriptor and positions load into registers meanwhile.
//   On the main path (K2 = 1024) a call waits once per barrier, with one
//   __syncthreads in all (after the barriers are initialised).
// - K2 > kStage runs a ring of two stage buffers: stage s+1 lands while
//   stage s is scanned; stage s+2 is issued into s's buffer once every warp
//   has left it (a __syncthreads, only on this path).
// - Bulk copies move 16-byte multiples from 16-byte aligned addresses
//   (stages start at multiples of 1024 points, the wrapper checks the
//   bases). A stage's ragged tail (an odd last position, up to 15 validity
//   bytes) goes by plain loads from the issuing thread, which also zeroes
//   the validity of the buffer's unused points, all published by its second
//   arrival on the positions barrier. Nothing is padded in the caller's
//   tensors.
// - One warp per query, ceil(K1 / SMs) queries per block (at most 16): one
//   block per SM at the main path's K1, so every SM stages the train set
//   once (8 queries per block at K1 = 1024, 12 at 1536).
// - Lane l owns the stage's point pairs (64 m + 2 l, 64 m + 2 l + 1): one
//   16-byte position load and one 2-byte validity load per pair, no bounds
//   test. A first pass keeps the gate results as one 32-bit mask; a second
//   pass reads descriptors and does popcounts only for the set bits, two at a
//   time, in ascending order. Each lane thus sees an ascending subsequence of
//   train indices and keeps (best, second, idx) with the TPU kernel's rule
//   (strict < for best, so the lowest index wins a tie; second =
//   min(max(best, d), second)); the 32 lane states merge by shuffles under
//   the same rule (ties in best go to the lower index).
// - The pixel gate du*du + dv*dv <= r*r is evaluated with __fmul_rn /
//   __fadd_rn so the compiler cannot contract it into an FMA, which would
//   flip train points lying exactly on the radius against the plain version;
//   r*r is rounded once on the host; a NaN distance is rejected. Without a
//   second query position (the wrapper then passes uv1 twice) a kernel
//   without the union gate runs.
// - A wait that never completes traps (a fault) instead of hanging the card.
// - Batched launch: B independent streams, each with its own [K1] queries
//   and [K2] train set, stacked contiguously ([B, K1, ...] / [B, K2, ...]).
//   blockIdx.y selects the stream and offsets every base pointer; blocks of
//   one stream stage only that stream's train set. The queries per block are
//   sized over all B*K1 queries (ceil(B*K1 / SMs), at most 16), so at B = 1
//   this is the single-stream launch above, and at B = 8 on the tracking
//   shape 16-warp blocks, 96 per stream, each staging its stream's train set
//   once. A stream's bulk copies need its train set to start 16-byte aligned:
//   the wrapper pads K2 to a multiple of 16 with invalid points when B > 1.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;                    // queries per block, at most
constexpr int kStage = 1024;                     // train points per stage
constexpr int kPairs = kStage / 64;              // point pairs per lane and stage
constexpr int kDescBytes = kStage * 32;
constexpr int kUvBytes = kStage * 8;
constexpr int kBufBytes = kDescBytes + kUvBytes + kStage;  // 41,984
constexpr int kBarBytes = 64;                    // [buffer][positions, descriptors] mbarriers
constexpr int kSmemMax = kBarBytes + 2 * kBufBytes;
constexpr int kMaxDevices = 64;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSmemMax <= 232448, "two stage buffers exceed a block's shared memory");
static_assert(kBufBytes % 16 == 0 && kDescBytes % 16 == 0 && kUvBytes % 16 == 0,
              "bulk copy destinations must stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 1; !mbar_try_wait(bar, parity); ++tries) {
    if (tries == (1u << 20)) __trap();  // a copy that never lands is a fault, not a hang
  }
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// min() that propagates NaN, as the plain version's torch.minimum does
__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// Squared pixel distance as two rounded products and one rounded sum: no FMA
// contraction, so points exactly on the radius fall as in the plain version.
__device__ __forceinline__ float dist2(float2 q, float x, float y) {
  const float du = q.x - x, dv = q.y - y;
  return __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
}

__device__ __forceinline__ float hamming(const uint32_t (&qd)[8], const uint8_t* desc, int j) {
  const uint4* row = reinterpret_cast<const uint4*>(desc + 32 * j);
  const uint4 a = row[0], c = row[1];
  return static_cast<float>(__popc(a.x ^ qd[0]) + __popc(a.y ^ qd[1]) +
                            __popc(a.z ^ qd[2]) + __popc(a.w ^ qd[3]) +
                            __popc(c.x ^ qd[4]) + __popc(c.y ^ qd[5]) +
                            __popc(c.z ^ qd[6]) + __popc(c.w ^ qd[7]));
}

// The TPU kernel's running top-2 over train points seen in ascending order:
// strict < for best (the lowest index wins a tie), a duplicate of best
// becomes second.
__device__ __forceinline__ void keep_top2(float d, int j, float& best, float& second, int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = j;
  } else if (d < second) {
    second = d;
  }
}

struct Stage {
  uint8_t* desc;   // [kStage][32]
  float2* uv;      // [kStage]
  uint8_t* valid;  // [kStage]; 0 past the stage's last point
};

__device__ __forceinline__ Stage stage_view(uint8_t* buf) {
  return {buf, reinterpret_cast<float2*>(buf + kDescBytes), buf + kDescBytes + kUvBytes};
}

// One thread: copy train points [t0, t0+n) into a stage buffer. Positions and
// validity complete `bar_pos` (two arrivals: the bulk copies' expect_tx, then
// the plain-store tail), descriptors complete `bar_desc` (one arrival). The
// tail is what the bulk copies cannot move (an odd last position, the last
// n % 16 validity bytes), plus zero validity for the buffer's unused points,
// so the scan needs no bounds test.
__device__ void issue_stage(uint8_t* buf, uint32_t bar_pos, uint32_t bar_desc,
                            const uint8_t* desc2, const float* uv2, const uint8_t* valid2,
                            int t0, int n) {
  const Stage st = stage_view(buf);
  const uint32_t uv_bulk = static_cast<uint32_t>(n & ~1) * 8;  // whole 16-byte pairs
  const int valid_bulk = n & ~15;
  mbar_arrive_expect_tx(bar_pos, uv_bulk + static_cast<uint32_t>(valid_bulk));
  if (uv_bulk) bulk_copy_g2s(smem_u32(st.uv), uv2 + 2 * (size_t)t0, uv_bulk, bar_pos);
  if (valid_bulk)
    bulk_copy_g2s(smem_u32(st.valid), valid2 + t0, static_cast<uint32_t>(valid_bulk), bar_pos);
  mbar_arrive_expect_tx(bar_desc, static_cast<uint32_t>(n) * 32);
  bulk_copy_g2s(smem_u32(st.desc), desc2 + 32 * (size_t)t0, static_cast<uint32_t>(n) * 32,
                bar_desc);
  if (n < kStage) {
    if (n & 1) {
      const int j = n - 1;
      st.uv[j] = make_float2(uv2[2 * (size_t)(t0 + j)], uv2[2 * (size_t)(t0 + j) + 1]);
    }
    uint32_t w[4] = {0, 0, 0, 0};  // the 16 bytes from valid_bulk on
    for (int j = valid_bulk; j < n; ++j)
      w[(j - valid_bulk) >> 2] |= static_cast<uint32_t>(valid2[t0 + j]) << (8 * (j & 3));
    uint4* v16 = reinterpret_cast<uint4*>(st.valid);
    v16[valid_bulk / 16] = make_uint4(w[0], w[1], w[2], w[3]);
    for (int k = valid_bulk / 16 + 1; k < kStage / 16; ++k) v16[k] = make_uint4(0, 0, 0, 0);
  }
  mbar_arrive(bar_pos);  // release: the tail's plain stores are seen by the waiters
}

// Pass 1 over a stage: lane l owns the point pairs (64 m + 2 l, 64 m + 2 l + 1),
// m < kPairs, read as one 16-byte position load and one 2-byte validity load
// (conflict-free: the lanes read consecutive addresses). Bit 2 m + k of the
// result <=> point 64 m + 2 l + k is valid and within the radius of the query
// (of either position with kUnion).
template <bool kUnion>
__device__ __forceinline__ uint32_t gate_mask(const Stage& st, int lane, float2 qp, float2 qa,
                                              float r2) {
  const float4* uv4 = reinterpret_cast<const float4*>(st.uv) + lane;
  const uint16_t* valid_pairs = reinterpret_cast<const uint16_t*>(st.valid) + lane;
  uint32_t hits = 0;
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const float4 t = uv4[32 * m];
    const uint32_t v = valid_pairs[32 * m];  // bool bytes: bit 0 and bit 8
    float a = dist2(qp, t.x, t.y), b = dist2(qp, t.z, t.w);
    if (kUnion) {
      a = min_nan(a, dist2(qa, t.x, t.y));
      b = min_nan(b, dist2(qa, t.z, t.w));
    }
    const uint32_t near = static_cast<uint32_t>(a <= r2) | (static_cast<uint32_t>(b <= r2) << 1);
    hits |= (near & (v | (v >> 7))) << (2 * m);  // NaN is never near
  }
  return hits;
}

// Block: one warp per query (blockDim.x / 32 queries) of stream blockIdx.y.
template <bool kUnion>
__global__ void __launch_bounds__(kMaxWarps * 32)
hamming_nn_top2_kernel(const uint8_t* __restrict__ desc1,
                       const float* __restrict__ uv1,
                       const float* __restrict__ uv1_alt,
                       const uint8_t* __restrict__ valid1, int k1,
                       const uint8_t* __restrict__ desc2,
                       const float* __restrict__ uv2,
                       const uint8_t* __restrict__ valid2, int k2, float r2,
                       float* __restrict__ best_out,
                       float* __restrict__ second_out,
                       int* __restrict__ idx_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // bars[2*b] positions, [2*b+1] descriptors
  uint8_t* bufs = smem + kBarBytes;

  // this block's stream: its queries, train set and outputs
  const size_t q0 = static_cast<size_t>(blockIdx.y) * k1, t0 = static_cast<size_t>(blockIdx.y) * k2;
  desc1 += q0 * 32;
  uv1 += q0 * 2;
  uv1_alt += q0 * 2;
  valid1 += q0;
  best_out += q0;
  second_out += q0;
  idx_out += q0;
  desc2 += t0 * 32;
  uv2 += t0 * 2;
  valid2 += t0;

  const int n_stages = (k2 + kStage - 1) / kStage;
  const int n_bufs = min(n_stages, 2);
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool q_in = q < k1;

  if (threadIdx.x == 0) {
    for (int b = 0; b < n_bufs; ++b) {
      mbar_init(smem_u32(&bars[2 * b]), 2);
      mbar_init(smem_u32(&bars[2 * b + 1]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int s = 0; s < n_bufs; ++s)
      issue_stage(bufs + s * kBufBytes, smem_u32(&bars[2 * s]), smem_u32(&bars[2 * s + 1]),
                  desc2, uv2, valid2, s * kStage, min(kStage, k2 - s * kStage));
  }

  // the query's descriptor and positions load while the stages are in flight
  uint32_t qd[8];
  float2 qp = make_float2(0.f, 0.f), qa = make_float2(0.f, 0.f);
  bool q_ok = false;
  if (q_in) {
    const uint4* p = reinterpret_cast<const uint4*>(desc1 + (size_t)q * 32);
    const uint4 a = p[0], b = p[1];
    qd[0] = a.x; qd[1] = a.y; qd[2] = a.z; qd[3] = a.w;
    qd[4] = b.x; qd[5] = b.y; qd[6] = b.z; qd[7] = b.w;
    qp = reinterpret_cast<const float2*>(uv1)[q];
    qa = reinterpret_cast<const float2*>(uv1_alt)[q];
    q_ok = valid1[q] != 0;
  } else {
    for (int w = 0; w < 8; ++w) qd[w] = 0;
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  float best = kBig, second = kBig;
  int idx = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int b = s & 1;
    const uint32_t parity = (s >> 1) & 1;
    const Stage st = stage_view(bufs + b * kBufBytes);

    // pass 1, positions and validity
    mbar_wait(smem_u32(&bars[2 * b]), parity);
    uint32_t hits = q_ok ? gate_mask<kUnion>(st, lane, qp, qa, r2) : 0u;

    // pass 2, descriptors: only the gated points, two at a time, ascending
    mbar_wait(smem_u32(&bars[2 * b + 1]), parity);
    while (hits) {
      const int i0 = __ffs(hits) - 1;
      hits &= hits - 1;
      const int i1 = hits ? __ffs(hits) - 1 : -1;
      hits &= hits - 1;
      const int j0 = 64 * (i0 >> 1) + 2 * lane + (i0 & 1);
      const int j1 = 64 * (max(i1, 0) >> 1) + 2 * lane + (max(i1, 0) & 1);
      const float d0 = hamming(qd, st.desc, j0);
      const float d1 = i1 < 0 ? kBig : hamming(qd, st.desc, j1);
      keep_top2(d0, s * kStage + j0, best, second, idx);
      keep_top2(d1, s * kStage + j1, best, second, idx);  // d1 = kBig keeps nothing
    }

    if (s + 2 < n_stages) {
      __syncthreads();  // no warp reads buffer b any more
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_stage(bufs + b * kBufBytes, smem_u32(&bars[2 * b]), smem_u32(&bars[2 * b + 1]),
                    desc2, uv2, valid2, (s + 2) * kStage, min(kStage, k2 - (s + 2) * kStage));
      }
    }
  }

  // merge the 32 lane states: each lane saw an ascending subsequence
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(kFull, best, off);
    const float os = __shfl_down_sync(kFull, second, off);
    const int oi = __shfl_down_sync(kFull, idx, off);
    second = fminf(fmaxf(best, ob), fminf(second, os));
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0 && q_in) {
    best_out[q] = best;
    second_out[q] = second;
    idx_out[q] = idx;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): `batch` streams of k1 queries and
// k2 train points each, stacked contiguously (batch = 1: one call). Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch (0 = success).
extern "C" int hamming_nn_top2_launch(const uint8_t* desc1, const float* uv1,
                                      const float* uv1_alt,
                                      const uint8_t* valid1, int k1,
                                      const uint8_t* desc2, const float* uv2,
                                      const uint8_t* valid2, int k2, float r2,
                                      float* best, float* second, int* idx,
                                      int batch, void* stream) {
  if (k1 <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);  // gridDim.y
  // once per device: the SM count, and the kernels' dynamic shared memory
  // limit raised for two stage buffers (over the default 48 KB)
  static int n_sm[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (n_sm[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hamming_nn_top2_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hamming_nn_top2_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    n_sm[dev] = sms;
  }
  // one block per SM where B*K1 allows, so each SM stages a train set once
  const long long queries = static_cast<long long>(batch) * k1;
  const int warps = static_cast<int>(
      std::min<long long>(kMaxWarps, (queries + n_sm[dev] - 1) / n_sm[dev]));
  const int n_stages = (k2 + kStage - 1) / kStage;
  const int smem = kBarBytes + std::min(n_stages, 2) * kBufBytes;
  const dim3 grid((k1 + warps - 1) / warps, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the wrapper passes uv1 as uv1_alt when the caller gave no second position
  if (uv1_alt == uv1)
    hamming_nn_top2_kernel<false><<<grid, warps * 32, smem, st>>>(
        desc1, uv1, uv1_alt, valid1, k1, desc2, uv2, valid2, k2, r2, best, second, idx);
  else
    hamming_nn_top2_kernel<true><<<grid, warps * 32, smem, st>>>(
        desc1, uv1, uv1_alt, valid1, k1, desc2, uv2, valid2, k2, r2, best, second, idx);
  return static_cast<int>(cudaGetLastError());
}
