// Windowed bundle adjustment's pose-only Levenberg-Marquardt (landmarks
// fixed), every iteration in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's LM
// (monocular_visual_odometry_tpu/models/ba.py::ba_solve) is one lax.scan that
// XLA fuses into a handful of kernels per iteration. The port's PyTorch loop
// (monocular_visual_odometry_tpu_torch/models/ba.py::lm_loop, this kernel's
// plain version) launches ~220 kernels per iteration, ~1.7 us each. This
// kernel is the card's counterpart of XLA's fusion: the whole solve, the
// re-gate included, in one launch, one thread block per stream.
//
// The math is lm_loop's with cfg.ba.fix_map_points: reprojection residuals
// of the window's observations at fixed landmarks, IRLS Huber weights on the
// information-weighted residual norm, per observation the 2x6 Jacobian of a
// left se(3) perturbation, per frame the 6x6 system (H + lambda I) delta =
// -g, solved by LU with partial pivoting; frames outside the window
// (frame_valid false) stay where they are; delta applied as se3_exp(delta) T,
// accepted when the robust cost falls (cost_new < cost_old), lambda halved on
// accept and quadrupled on reject, the accepted cost per valid observation
// recorded after each iteration. With the re-gate on, entering iteration
// iterations / 2 the observations whose squared residual at the current
// poses passes max(regate_px^2, sigma_mult^2 * median) or whose point is
// behind the camera are dropped, a frame left under 3 keeps its mask, and the
// accepted cost is re-based on the new mask. float32 throughout, or float64
// (cfg.ba.deterministic) as a second instantiation of the same template.
//
// What bounds it on this card: latency, not bytes or operations. At the live
// shape (5 frames x 1,024 observations, 12 iterations) the work is ~10 MFLOP
// and ~0.1 MB, well under a microsecond of the card's peaks; but the 12
// iterations are dependent (each solve needs the previous accept test), and
// each needs a reduction over every observation before 5 small solves.
//
// Design:
// - One block of 512 threads per stream (a batched launch: blockIdx.x picks
//   the stream). The observations (pixel, landmark position; 20 bytes) are
//   gathered once into shared memory and read from there by every pass;
//   whatever does not fit (a window of over ~10,800 observations in float32)
//   is read from global memory each pass. Their masks live in shared memory
//   too (one byte each; the re-gate rewrites them).
// - One fused pass per iteration, at the trial poses: residuals, weights,
//   cost, valid count, Jacobians and the 21 + 6 unique terms of H and g per
//   frame. The warps are split between the frames (16 / W warps a frame, a
//   warp never crosses frames), each thread sums its observations in
//   registers, a warp reduce-scatters its 32 sums in 31 shuffles (lane l
//   ends with sum l), and one more step adds the warps of a frame. Every sum
//   has a fixed order, so a result does not depend on timing.
// - The linearisation is reused on reject: the pass at the trial poses also
//   gives their H and g, which are the next iteration's system if the trial is
//   accepted; if it is rejected the state is unchanged and the old system
//   still holds. So an iteration is one pass, where lm_loop linearises and
//   then evaluates the cost in two. 13 passes in all at 12 iterations.
// - W threads then solve the W systems (6x6 LU in registers) and apply
//   se3_exp; every thread reads the same sums from shared memory and takes the
//   same accept decision, so no flag is broadcast.
// - The re-gate's median is a radix select over the squared residuals' bit
//   patterns (8 bits a round, a 256-bin shared histogram; invalid
//   observations count as +inf, as lm_loop's sort puts them last).
// - Landmark indices are clamped to the map (lm_loop indexes with them as
//   they are; gather_window clamps them already).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;            // per frame: 21 H (upper triangle, row-major), 6 g,
constexpr int kG = 21, kCost = 27, kCount = 28;  // cost, valid count, 3 unused
constexpr int kStageBytes = 20;       // u, v, X, Y, Z as float
constexpr int kSmemMax = 232448;      // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;

struct Args {
  const float* T;              // [B, W, 4, 4] camera-from-world
  const float* uv;             // [B, W, K, 2]
  const int32_t* pid;          // [B, W, K]
  const uint8_t* valid;        // [B, W, K]
  const float* pts;            // [B, M, 3]
  const uint8_t* frame_valid;  // [B, W]
  float* T_out;                // [B, W, 4, 4]
  float* costs;                // [B, iterations]
  int W, K, M, iterations, n_stage, regate, use_sigma;
  double fx, fy, cx, cy, i00, i01, i10, i11, huber, lam0, gate2, sigma2;
};

template <typename S>
struct Consts {
  S fx, fy, cx, cy, i00, i01, i10, i11, huber;
};

template <typename S>
struct Obs {
  S u, v, X, Y, Z;
};

template <typename S> struct KeyOf;
template <> struct KeyOf<float> {
  using T = uint32_t;
  static __device__ T bits(float x) { return __float_as_uint(x); }
  static __device__ float value(T k) { return __uint_as_float(k); }
};
template <> struct KeyOf<double> {
  using T = unsigned long long;
  static __device__ T bits(double x) { return static_cast<T>(__double_as_longlong(x)); }
  static __device__ double value(T k) { return __longlong_as_double(static_cast<long long>(k)); }
};

// torch.clamp(x, min=lo): NaN stays NaN
template <typename S>
__device__ __forceinline__ S clamp_min(S x, S lo) { return x < lo ? lo : x; }

template <typename S>
__device__ __forceinline__ void sin_cos(S x, S* s, S* c) {
  if constexpr (sizeof(S) == 4) sincosf(x, s, c); else sincos(x, s, c);
}

template <typename S>
__device__ __forceinline__ S inf_value() {
  if constexpr (sizeof(S) == 4) return __int_as_float(0x7f800000);
  else return __longlong_as_double(0x7ff0000000000000LL);
}

// Camera-frame point and residual of one observation at pose T (3x4, row-major).
template <typename S>
__device__ __forceinline__ void project(const S* T, const Obs<S>& o, const Consts<S>& c,
                                        S& px, S& py, S& pz, S& iz, S& r0, S& r1) {
  px = (T[0] * o.X + T[1] * o.Y + T[2] * o.Z) + T[3];
  py = (T[4] * o.X + T[5] * o.Y + T[6] * o.Z) + T[7];
  pz = (T[8] * o.X + T[9] * o.Y + T[10] * o.Z) + T[11];
  iz = S(1) / clamp_min(pz, S(1e-6));
  r0 = (px * iz * c.fx + c.cx) - o.u;
  r1 = (py * iz * c.fy + c.cy) - o.v;
}

// One observation's share of its frame's sums: H (upper triangle), g, cost, count.
template <typename S>
__device__ __forceinline__ void accumulate(const S* T, const Obs<S>& o, bool valid,
                                           const Consts<S>& c, S (&acc)[kSlots]) {
  S px, py, pz, iz, r0, r1;
  project(T, o, c, px, py, pz, iz, r0, r1);
  const S e2 = r0 * r0 * c.i00 + r1 * r1 * c.i11 + S(2) * r0 * r1 * c.i01;
  const S e = sqrt(clamp_min(e2, S(1e-12)));
  const S w = valid ? (e <= c.huber ? S(1) : c.huber / e) : S(0);
  acc[kCost] += w * e2;
  acc[kCount] += valid ? S(1) : S(0);
  // d(u, v)/d(rho, phi) = J_proj [I | -hat(p)]
  const S a0 = c.fx * iz, a2 = -c.fx * px * (iz * iz);
  const S b1 = c.fy * iz, b2 = -c.fy * py * (iz * iz);
  const S J0[6] = {a0, S(0), a2, a2 * py, a0 * pz - a2 * px, -a0 * py};
  const S J1[6] = {S(0), b1, b2, b2 * py - b1 * pz, -b2 * px, b1 * px};
  S JW0[6], JW1[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    JW0[i] = (J0[i] * c.i00 + J1[i] * c.i10) * w;
    JW1[i] = (J0[i] * c.i01 + J1[i] * c.i11) * w;
  }
  const S wr0 = (c.i00 * r0 + c.i01 * r1) * w;
  const S wr1 = (c.i10 * r0 + c.i11 * r1) * w;
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[s++] += JW0[i] * J0[j] + JW1[i] * J1[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[kG + i] += J0[i] * wr0 + J1[i] * wr1;
}

// Reduce-scatter of 32 values over a warp: lane l returns the warp's sum of
// value l, in 16 + 8 + 4 + 2 + 1 shuffles.
template <typename S>
__device__ __forceinline__ S warp_reduce_scatter(S (&v)[kSlots], int lane) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const bool hi = (lane & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const S send = hi ? v[i] : v[i + w];
      const S keep = hi ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  return v[0];
}

// One frame's LM step: solve (H + lam I) delta = -g by LU with partial
// pivoting, then T_new = se3_exp(delta) T (both 4x4, row-major).
template <typename S>
__device__ void frame_step(const S* sums, S lam, const S* T, S* T_new) {
  S A[6][6], y[6];
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = sums[s];
      A[j][i] = sums[s];
      ++s;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + lam;
    y[i] = sums[kG + i];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    S best = fabs(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(A[r][c]) > best) {
        best = fabs(A[r][c]);
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int k = c; k < 6; ++k) {
          const S t = A[c][k];
          A[c][k] = A[r][k];
          A[r][k] = t;
        }
        const S t = y[c];
        y[c] = y[r];
        y[r] = t;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const S f = A[r][c] / A[c][c];
#pragma unroll
      for (int k = c + 1; k < 6; ++k) A[r][k] -= f * A[c][k];
      y[r] -= f * y[c];
    }
  }
  S x[6];
#pragma unroll
  for (int c = 5; c >= 0; --c) {
    S v = y[c];
#pragma unroll
    for (int k = c + 1; k < 6; ++k) v -= A[c][k] * x[k];
    x[c] = v / A[c][c];
  }
  // delta = -x = [rho, phi]; se3_exp as ops/lie.py computes it
  const S rho[3] = {-x[0], -x[1], -x[2]};
  const S f0 = -x[3], f1 = -x[4], f2 = -x[5];
  const S th2 = f0 * f0 + f1 * f1 + f2 * f2;
  const S eps2 = S(1e-16);
  const S th = sqrt(th2 + eps2);
  const bool small = th2 < S(1e-8);
  S sn, cs;
  sin_cos(th, &sn, &cs);
  const S a = small ? S(1) - th2 / S(6) : sn / th;
  const S b = small ? S(0.5) - th2 / S(24) : (S(1) - cs) / (th2 + eps2);
  const S cq = small ? S(1.0 / 6.0) - th2 / S(120) : (th - sn) / (th2 * th + eps2);
  const S Wm[3][3] = {{S(0), -f2, f1}, {f2, S(0), -f0}, {-f1, f0, S(0)}};
  S R[3][3], V[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S w2 = Wm[i][0] * Wm[0][j] + Wm[i][1] * Wm[1][j] + Wm[i][2] * Wm[2][j];
      const S id = i == j ? S(1) : S(0);
      R[i][j] = id + a * Wm[i][j] + b * w2;
      V[i][j] = id + b * Wm[i][j] + cq * w2;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      T_new[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j] + t[i] * T[12 + j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) T_new[12 + j] = T[12 + j];
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1) ba_lm_pose_kernel(const Args a) {
  using Key = typename KeyOf<S>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.W, K = a.K, N = W * K, n_stage = a.n_stage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpf = W >= kWarps ? 1 : kWarps / W;   // warps per frame
  const int groups = kWarps / wpf;                // frames summed at once
  const size_t b = blockIdx.x;

  S* sums = reinterpret_cast<S*>(smem);           // [2][W][kSlots]
  S* Tm = sums + 2 * W * kSlots;                  // [2][W][16]
  S* red = Tm + 2 * W * 16;                       // [W * wpf][kSlots]
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(red + W * wpf * kSlots);
  unsigned* hist = reinterpret_cast<unsigned*>(sel + 2);   // [256]
  int* cnt = reinterpret_cast<int*>(hist + 256);  // [W]
  float* stage = reinterpret_cast<float*>(cnt + W);        // [5][n_stage]
  uint8_t* ov = reinterpret_cast<uint8_t*>(stage + 5 * n_stage);  // [N]: bit 0 valid

  const float* T_in = a.T + b * W * 16;
  const float* uv = a.uv + b * N * 2;
  const int32_t* pid = a.pid + b * N;
  const uint8_t* valid = a.valid + b * N;
  const float* pts = a.pts + b * a.M * 3;
  const uint8_t* frame_valid = a.frame_valid + b * W;
  const Consts<S> c = {S(a.fx), S(a.fy), S(a.cx), S(a.cy), S(a.i00), S(a.i01),
                       S(a.i10), S(a.i11), S(a.huber)};

  auto gather = [&](int j, float* o) {
    const int p = min(max(pid[j], 0), a.M - 1);
    o[0] = uv[2 * (size_t)j];
    o[1] = uv[2 * (size_t)j + 1];
    o[2] = pts[3 * (size_t)p];
    o[3] = pts[3 * (size_t)p + 1];
    o[4] = pts[3 * (size_t)p + 2];
  };
  auto load = [&](int j) {
    float o[5];
    if (j < n_stage) {
#pragma unroll
      for (int i = 0; i < 5; ++i) o[i] = stage[i * n_stage + j];
    } else {
      gather(j, o);
    }
    return Obs<S>{S(o[0]), S(o[1]), S(o[2]), S(o[3]), S(o[4])};
  };

  for (int j = tid; j < N; j += kThreads) {
    ov[j] = valid[j] ? 1 : 0;
    if (j < n_stage) {
      float o[5];
      gather(j, o);
#pragma unroll
      for (int i = 0; i < 5; ++i) stage[i * n_stage + j] = o[i];
    }
  }
  for (int i = tid; i < W * 16; i += kThreads) Tm[i] = S(T_in[i]);
  __syncthreads();

  // Each frame's sums at the poses Tb into out ([W][kSlots]).
  auto pass = [&](const S* Tb, S* out) {
    const int g = warp / wpf, q = warp % wpf;
    for (int f = g; f < W; f += groups) {
      S T[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) T[i] = Tb[16 * f + i];
      S acc[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] = S(0);
      for (int k = q * 32 + lane; k < K; k += wpf * 32) {
        const int j = f * K + k;
        accumulate(T, load(j), (ov[j] & 1) != 0, c, acc);
      }
      red[(f * wpf + q) * kSlots + lane] = warp_reduce_scatter(acc, lane);
    }
    __syncthreads();
    for (int i = tid; i < W * kSlots; i += kThreads) {
      const int f = i / kSlots, s = i % kSlots;
      S v = S(0);
      for (int r = 0; r < wpf; ++r) v += red[(f * wpf + r) * kSlots + s];
      out[i] = v;
    }
    __syncthreads();
  };
  auto total = [&](const S* sm, int s) {
    S v = S(0);
    for (int f = 0; f < W; ++f) v += sm[f * kSlots + s];
    return v;
  };
  // squared residual and depth of observation j at the poses Tb
  auto err2_at = [&](const S* Tb, int j, S& pz) {
    const S* T = Tb + 16 * (j / K);
    S px, py, iz, r0, r1;
    project(T, load(j), c, px, py, pz, iz, r0, r1);
    return r0 * r0 + r1 * r1;
  };

  // The chi2 re-gate at the poses Tb; nv observations valid.
  auto regate = [&](const S* Tb, long long nv) {
    for (int i = tid; i < W; i += kThreads) cnt[i] = 0;
    // the median: element (nv - 1) / 2 of the squared residuals sorted, the
    // invalid ones as +inf (lm_loop's sort), by a radix select on their bits
    Key prefix = 0, mask = 0;
    unsigned long long krem = nv >= 1 ? static_cast<unsigned long long>((nv - 1) / 2) : 0ull;
    for (int shift = 8 * static_cast<int>(sizeof(Key)) - 8; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int j = tid; j < N; j += kThreads) {
        S pz;
        const S e2 = err2_at(Tb, j, pz);
        const Key key = KeyOf<S>::bits((ov[j] & 1) ? e2 : inf_value<S>());
        if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        unsigned long long below = 0;
        int d = 0;
        for (; d < 255; ++d) {
          if (below + hist[d] > krem) break;
          below += hist[d];
        }
        sel[0] = static_cast<unsigned long long>(prefix | (static_cast<Key>(d) << shift));
        sel[1] = krem - below;
      }
      __syncthreads();
      prefix = static_cast<Key>(sel[0]);
      krem = sel[1];
      mask |= static_cast<Key>(255) << shift;
    }
    S med2 = KeyOf<S>::value(prefix);
    if (!isfinite(med2)) med2 = S(0);
    S gate2 = S(a.gate2);
    if (a.use_sigma) {
      const S g2 = S(a.sigma2) * med2;
      gate2 = gate2 < g2 ? g2 : gate2;
    }
    // keep = valid, in front of the camera and under the gate; a frame
    // left under 3 keeps its mask
    for (int j = tid; j < N; j += kThreads) {
      S pz;
      const S e2 = err2_at(Tb, j, pz);
      if ((ov[j] & 1) && pz > S(0) && e2 < gate2) {
        atomicAdd(&cnt[j / K], 1);
        ov[j] |= 2;
      }
    }
    __syncthreads();
    for (int j = tid; j < N; j += kThreads) {
      const uint8_t o = ov[j];
      ov[j] = cnt[j / K] >= 3 ? static_cast<uint8_t>(o >> 1) : static_cast<uint8_t>(o & 1);
    }
    __syncthreads();
  };

  S* cur_s = sums;
  S* new_s = sums + W * kSlots;
  S* cur_T = Tm;
  S* new_T = Tm + W * 16;
  pass(cur_T, cur_s);
  S cost_old = total(cur_s, kCost);
  S n_obs = total(cur_s, kCount);
  n_obs = n_obs < S(1) ? S(1) : n_obs;
  S lam = S(a.lam0);
  const int n1 = a.iterations / 2;
  for (int it = 0; it < a.iterations; ++it) {
    if (a.regate && it == n1 && N > 0) {
      regate(cur_T, static_cast<long long>(total(cur_s, kCount)));
      pass(cur_T, cur_s);
      cost_old = total(cur_s, kCost);
      n_obs = total(cur_s, kCount);
      n_obs = n_obs < S(1) ? S(1) : n_obs;
    }
    for (int f = tid; f < W; f += kThreads) {
      if (frame_valid[f]) {
        frame_step(cur_s + f * kSlots, lam, cur_T + 16 * f, new_T + 16 * f);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) new_T[16 * f + i] = cur_T[16 * f + i];
      }
    }
    __syncthreads();
    pass(new_T, new_s);
    const S cost_new = total(new_s, kCost);
    if (cost_new < cost_old) {   // accept: the trial's sums are the next system
      S* t = cur_s; cur_s = new_s; new_s = t;
      t = cur_T; cur_T = new_T; new_T = t;
      cost_old = cost_new;
      lam = lam * S(0.5);
    } else {
      lam = lam * S(4);
    }
    if (tid == 0) a.costs[b * a.iterations + it] = static_cast<float>(cost_old / n_obs);
  }
  for (int i = tid; i < W * 16; i += kThreads) a.T_out[b * W * 16 + i] = static_cast<float>(cur_T[i]);
}

// Dynamic shared memory of a launch; n_stage observations staged (-1 if the
// fixed part and the masks do not fit).
long long smem_bytes(int W, long long N, long long s_bytes, long long* n_stage) {
  const int wpf = W >= kWarps ? 1 : kWarps / W;
  const long long fixed = static_cast<long long>(2 * W * kSlots + 2 * W * 16 + W * wpf * kSlots) * s_bytes
                          + 16 + 256 * 4 + 4LL * W;
  const long long room = kSmemMax - fixed - N;
  if (room < 0) return -1;
  *n_stage = room / kStageBytes < N ? room / kStageBytes : N;
  return fixed + kStageBytes * *n_stage + N;
}

}  // namespace

// Plain C entry point (loaded with ctypes): `batch` streams, each with a
// window of W frames x K observations over M landmarks, stacked contiguously
// (batch = 1: one call). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch (0 = success), or -1 if a window of
// this size does not fit in a block's shared memory.
extern "C" int ba_lm_pose_launch(const float* T, const float* uv, const int32_t* pid,
                                 const uint8_t* valid, const float* pts,
                                 const uint8_t* frame_valid, int batch, int W, int K, int M,
                                 int iterations, double fx, double fy, double cx, double cy,
                                 double i00, double i01, double i10, double i11, double huber,
                                 double lam0, double regate_px, double sigma_mult, int float64,
                                 float* T_out, float* costs, void* stream) {
  if (batch <= 0) return 0;
  if (W <= 0 || K < 0 || M <= 0 || iterations < 0) return -1;
  long long n_stage = 0;
  const long long smem = smem_bytes(W, static_cast<long long>(W) * K,
                                    float64 ? 8LL : 4LL, &n_stage);
  if (smem < 0 || static_cast<long long>(W) * K > 0x7fffffffLL) return -1;
  // once per device: both kernels' dynamic shared memory limit raised to a
  // block's whole shared memory (over the default 48 KB)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(ba_lm_pose_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ba_lm_pose_kernel<double>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  Args a;
  a.T = T; a.uv = uv; a.pid = pid; a.valid = valid; a.pts = pts; a.frame_valid = frame_valid;
  a.T_out = T_out; a.costs = costs;
  a.W = W; a.K = K; a.M = M; a.iterations = iterations; a.n_stage = static_cast<int>(n_stage);
  a.regate = regate_px > 0 && iterations >= 2;
  a.use_sigma = sigma_mult > 0;
  a.fx = fx; a.fy = fy; a.cx = cx; a.cy = cy;
  a.i00 = i00; a.i01 = i01; a.i10 = i10; a.i11 = i11;
  a.huber = huber; a.lam0 = lam0;
  a.gate2 = regate_px * regate_px;
  a.sigma2 = sigma_mult * sigma_mult;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (float64)
    ba_lm_pose_kernel<double><<<batch, kThreads, static_cast<size_t>(smem), st>>>(a);
  else
    ba_lm_pose_kernel<float><<<batch, kThreads, static_cast<size_t>(smem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
