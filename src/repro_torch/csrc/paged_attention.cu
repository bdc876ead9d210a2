// Attention over a paged KV pool: one-token decode and chunked prefill.
//
// Replaces: repro/kernels/paged_attention.py::paged_attention -> _kernel
// (decode) and ::paged_prefill -> _prefill_kernel (chunked prefill), fp
// pools; and, for int8 pools, ::paged_attention -> _kernel_quant and
// ::paged_prefill -> _prefill_kernel_quant (with _dequant_page).  All four
// entry points share one kernel: decode is a 1-token chunk whose query
// sits at position lengths[b] - 1.
//
// Bound on the H100: bytes for decode (each live K/V page is read once per
// kv head and used by only rep = H / Hkv query rows), and for prefill the
// same K/V bytes plus 4 * D operations per (query row, visible key).  Int8
// pools halve the K/V bytes; their scales add 2 * 4 bytes per (token, kv
// head) per-token, or per (page, kv head) per-page.
//
// Int8 pools: the staging loop below converts each K/V element to fp32 on
// its way into shared memory anyway; with scales it multiplies by the
// token's scale (scales[(page * ps + off) * Hkv + g], per-token) or the
// page's (scales[page * Hkv + g], per-page), in fp32, as _dequant_page
// does.  Everything after staging is the fp kernel, so no fp copy of the
// cache ever reaches global memory.  Only keys below the row's length are
// staged, so unwritten scale cells (zeros) and payload cells are never
// read.
//
// Design: one block per (row b, kv head g, tile of query positions); the
// tile holds up to 32 query rows (positions x the rep query heads that
// share kv head g, so K/V are read once per kv head, never repeated).  Four
// warps own the rows; a lane holds D/32 elements of its rows' q and fp32
// output accumulators in registers.  The block walks only the keys any of
// its rows can see — min(causal horizon, length) — staging 16 tokens of K
// and V at a time in shared memory through the block table, so pages past
// the row's length (block-table padding at the null page) are never read.
// Each (row, key) logit is a warp-shuffle dot product followed by an online
// softmax update (running max, normalizer, rescaled accumulator).  A row
// that sees no key keeps a zero accumulator and a zero normalizer, and the
// clamped denominator max(l, 1e-20) writes exact zeros, never NaN.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int DMAX = 128;           // head_dim <= 128, multiple of 32
constexpr int DJ = DMAX / 32;       // elements per lane
constexpr int RPW = 8;              // query rows per warp
constexpr int ROWS = WARPS * RPW;   // query rows per block
constexpr int TOK = 16;             // K/V tokens staged at a time

// scale pools of int8 payloads: none (fp pools), one per token, one per page
enum { SCALE_NONE = 0, SCALE_TOKEN = 1, SCALE_PAGE = 2 };

template <typename TQ, typename TK, typename TS, int SM>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const TQ* __restrict__ q, const TK* __restrict__ kp,
            const TK* __restrict__ vp, const TS* __restrict__ ksc,
            const TS* __restrict__ vsc, const int32_t* __restrict__ bt,
            const int32_t* __restrict__ seq_start,
            const int32_t* __restrict__ lengths, TQ* __restrict__ out, int S,
            int H, int Hkv, int D, int ps, int maxp, int qt, float scale,
            int decode) {
  __shared__ float ks[TOK][DMAX];
  __shared__ float vs[TOK][DMAX];
  const int b = blockIdx.x, g = blockIdx.y;
  const int i0 = blockIdx.z * qt;            // first query position of tile
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nj = D / 32;
  const int cap = maxp * ps;                 // keys the block table covers
  const int len = min(lengths[b], cap);
  const int start = decode ? lengths[b] - 1 : seq_start[b];
  const int nq = min(qt, S - i0);
  const int R = nq * rep;

  float qv[RPW][DJ], acc[RPW][DJ], mrow[RPW], lrow[RPW];
  int lim[RPW];                              // row sees keys kpos < lim
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
    lim[i] = 0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) qv[i][j] = acc[i][j] = 0.f;
    if (r < R) {
      const int ti = r / rep, hr = r - ti * rep;
      const TQ* qr = q + (((size_t)b * S + i0 + ti) * H + g * rep + hr) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        if (j < nj) qv[i][j] = to_f32(qr[lane + 32 * j]);
      lim[i] = max(0, min(start + i0 + ti + 1, len));
    }
  }
  // keys the tile's last query position can see (the widest row)
  const int horizon = max(0, min(start + i0 + nq, len));

  for (int t0 = 0; t0 < horizon; t0 += TOK) {
    const int nt = min(TOK, horizon - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < nt * D; e += THREADS) {
      const int tt = e / D, d = e - tt * D;
      const int kpos = t0 + tt;
      const int page = bt[(size_t)b * maxp + kpos / ps];
      const size_t cell = ((size_t)page * ps + kpos % ps) * Hkv + g;
      float kf = to_f32(kp[cell * D + d]), vf = to_f32(vp[cell * D + d]);
      if constexpr (SM == SCALE_TOKEN) {
        kf *= to_f32(ksc[cell]);
        vf *= to_f32(vsc[cell]);
      } else if constexpr (SM == SCALE_PAGE) {
        const size_t pg = (size_t)page * Hkv + g;
        kf *= to_f32(ksc[pg]);
        vf *= to_f32(vsc[pg]);
      }
      ks[tt][d] = kf;
      vs[tt][d] = vf;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const int kpos = t0 + tt;
      float kv[DJ], vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        kv[j] = j < nj ? ks[tt][lane + 32 * j] : 0.f;
        vv[j] = j < nj ? vs[tt][lane + 32 * j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (kpos >= lim[i]) continue;        // warp-uniform: masked key
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) s = fmaf(qv[i][j], kv[j], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        s *= scale;
        const float mnew = fmaxf(mrow[i], s);
        const float corr = expf(mrow[i] - mnew);   // 0 for the first key
        const float p = expf(s - mnew);
        lrow[i] = lrow[i] * corr + p;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j] * corr);
        mrow[i] = mnew;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= R) continue;
    const int ti = r / rep, hr = r - ti * rep;
    TQ* orow = out + (((size_t)b * S + i0 + ti) * H + g * rep + hr) * D;
    const float inv = 1.f / fmaxf(lrow[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (j < nj) orow[lane + 32 * j] = from_f32<TQ>(acc[i][j] * inv);
  }
}

template <typename TQ, typename TK, typename TS, int SM>
void launch(const void* q, const void* kp, const void* vp, const void* ksc,
            const void* vsc, const void* bt, const void* st, const void* ln,
            void* out, int B, int S, int H, int Hkv, int D, int ps, int maxp,
            int qt, float scale, int decode, cudaStream_t stream) {
  dim3 grid(B, Hkv, (S + qt - 1) / qt), block(THREADS);
  attn_kernel<TQ, TK, TS, SM><<<grid, block, 0, stream>>>(
      (const TQ*)q, (const TK*)kp, (const TK*)vp, (const TS*)ksc,
      (const TS*)vsc, (const int32_t*)bt, (const int32_t*)st,
      (const int32_t*)ln, (TQ*)out, S, H, Hkv, D, ps, maxp, qt, scale,
      decode);
}

// kv_dtype DT_I8 takes scale pools (s_dtype, per_page); fp pools take none
int dispatch(const void* q, const void* kp, const void* vp, const void* ksc,
             const void* vsc, const void* bt, const void* st, const void* ln,
             void* out, int B, int S, int H, int Hkv, int D, int ps, int maxp,
             float scale, int decode, int q_dtype, int kv_dtype, int s_dtype,
             int per_page, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || D % 32 || D > DMAX ||
      ps < 1 || maxp < 1 || H / Hkv > ROWS || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == DT_I8) != (ksc != nullptr && vsc != nullptr) ||
      (kv_dtype != DT_I8 && (ksc != nullptr || vsc != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int qt = decode ? 1 : min(S, ROWS / rep);
  if ((S + qt - 1) / qt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PA_LAUNCH(TQ, TK, TS, SM)                                           \
  launch<TQ, TK, TS, SM>(q, kp, vp, ksc, vsc, bt, st, ln, out, B, S, H, Hkv, \
                         D, ps, maxp, qt, scale, decode, s)
  typedef __nv_bfloat16 bf16;
  const bool qf = q_dtype == DT_F32, qb = q_dtype == DT_BF16;
  if (kv_dtype == DT_I8) {
    const bool sf = s_dtype == DT_F32, sb = s_dtype == DT_BF16;
    if (qf && sf && !per_page) PA_LAUNCH(float, int8_t, float, SCALE_TOKEN);
    else if (qf && sf && per_page) PA_LAUNCH(float, int8_t, float, SCALE_PAGE);
    else if (qf && sb && !per_page) PA_LAUNCH(float, int8_t, bf16, SCALE_TOKEN);
    else if (qf && sb && per_page) PA_LAUNCH(float, int8_t, bf16, SCALE_PAGE);
    else if (qb && sf && !per_page) PA_LAUNCH(bf16, int8_t, float, SCALE_TOKEN);
    else if (qb && sf && per_page) PA_LAUNCH(bf16, int8_t, float, SCALE_PAGE);
    else if (qb && sb && !per_page) PA_LAUNCH(bf16, int8_t, bf16, SCALE_TOKEN);
    else if (qb && sb && per_page) PA_LAUNCH(bf16, int8_t, bf16, SCALE_PAGE);
    else return (int)cudaErrorInvalidValue;
  } else if (qf && kv_dtype == DT_F32) {
    PA_LAUNCH(float, float, float, SCALE_NONE);
  } else if (qf && kv_dtype == DT_BF16) {
    PA_LAUNCH(float, bf16, float, SCALE_NONE);
  } else if (qb && kv_dtype == DT_F32) {
    PA_LAUNCH(bf16, float, float, SCALE_NONE);
  } else if (qb && kv_dtype == DT_BF16) {
    PA_LAUNCH(bf16, bf16, float, SCALE_NONE);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Decode: q/out (B, H, D); lengths (B,) counts the keys each row sees.
extern "C" int paged_attention(const void* q, const void* kp, const void* vp,
                               const void* bt, const void* lengths, void* out,
                               int B, int H, int Hkv, int D, int ps, int maxp,
                               float scale, int q_dtype, int kv_dtype,
                               void* stream) {
  return dispatch(q, kp, vp, nullptr, nullptr, bt, lengths, lengths, out, B,
                  1, H, Hkv, D, ps, maxp, scale, 1, q_dtype, kv_dtype, 0, 0,
                  stream);
}

// Chunked prefill: q/out (B, S, H, D); query i of row b sits at
// seq_start[b] + i and sees keys kpos <= qpos with kpos < lengths[b].
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* bt, const void* seq_start,
                             const void* lengths, void* out, int B, int S,
                             int H, int Hkv, int D, int ps, int maxp,
                             float scale, int q_dtype, int kv_dtype,
                             void* stream) {
  return dispatch(q, kp, vp, nullptr, nullptr, bt, seq_start, lengths, out,
                  B, S, H, Hkv, D, ps, maxp, scale, 0, q_dtype, kv_dtype, 0,
                  0, stream);
}

// Int8 decode: pools int8 (P, ps, Hkv, D); ksc/vsc (P, ps, Hkv) per-token
// or, with per_page, (P, Hkv); s_dtype their storage type.
extern "C" int paged_attention_int8(const void* q, const void* kp,
                                    const void* vp, const void* ksc,
                                    const void* vsc, const void* bt,
                                    const void* lengths, void* out, int B,
                                    int H, int Hkv, int D, int ps, int maxp,
                                    float scale, int q_dtype, int s_dtype,
                                    int per_page, void* stream) {
  return dispatch(q, kp, vp, ksc, vsc, bt, lengths, lengths, out, B, 1, H,
                  Hkv, D, ps, maxp, scale, 1, q_dtype, DT_I8, s_dtype,
                  per_page, stream);
}

// Int8 chunked prefill: as paged_prefill, with scale pools as above.
extern "C" int paged_prefill_int8(const void* q, const void* kp,
                                  const void* vp, const void* ksc,
                                  const void* vsc, const void* bt,
                                  const void* seq_start, const void* lengths,
                                  void* out, int B, int S, int H, int Hkv,
                                  int D, int ps, int maxp, float scale,
                                  int q_dtype, int s_dtype, int per_page,
                                  void* stream) {
  return dispatch(q, kp, vp, ksc, vsc, bt, seq_start, lengths, out, B, S, H,
                  Hkv, D, ps, maxp, scale, 0, q_dtype, DT_I8, s_dtype,
                  per_page, stream);
}
