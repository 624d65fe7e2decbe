// Point-in-polygon parity kernel for the geofence stage, for Hopper (sm_90a).
//
// Replaces the TPU kernel sitewhere_tpu/ops/geo_pallas.py:_pip_kernel (:41),
// launched there by points_in_polygons_pallas (:68, pallas_call at :104).
// It computes the same function: for each point b and polygon z, the parity
// of ray crossings over the polygon's V edges, out[b, z] = 1 when odd.
//
// Inputs, as the step hands them to the geofence (no layout in between):
//   points  float32[B, 2]     (x, y) = (lon, lat), read as float2
//   verts   float32[Z, V, 2]  padded rings; edge v runs from vertex v to
//                             vertex (v + 1) % V
//   out     uint8[B, Z]       (a torch.bool tensor's bytes)
//
// What bounds it on the card: issue slots.  B*Z*V edge tests (2^30 at
// B=131072, Z=512, V=16) against B*Z bytes written.  Each test is decided
// from the signs of three rounded floats, all on the full-rate float pipe:
//   d[v] = py - y[v]                   the crossing's own subtraction;
//                                      sign(d[v]) is the compare y[v] > py
//   x_cross = slope[v] * d[v] + x[v]   rounded after the mul and the add
//   e[v] = px - x_cross                sign(e[v]) is the compare px < x_cross
// so a test costs 4 float instructions (sub, mul, add, sub) -- the
// y-compare of vertex v+1 is d[v+1], shared with edge v+1 -- and 1.5 logic
// instructions on the half-rate ALU: one LOP3 for (d[v] ^ d[v+1]) & e[v],
// whose sign bit is "straddles and crosses", and half a LOP3 to xor two of
// those into the parity word.  No predicate and no compare in the loop.
//
// Why the signs are the compares, bitwise: with subnormals (no flush to
// zero) a rounded a - b is 0 only when a == b, and otherwise has the sign
// of the exact difference; a == b gives +0.  So sign(a - b) == (a < b)
// once no operand is -0 (canonicalised to +0 when staged, which moves no
// compare) and no NaN carries a sign bit: NaN inputs are staged as the
// canonical NaN 0x7fffffff, and the card's arithmetic returns that NaN
// for any NaN result (inf * 0 included), where every compare is false.
// The crossing abscissa keeps the plain version's value: x_cross is
// rounded as ops/geo.py rounds it, and a zero's sign changes no compare.
//
// The design:
//   * a block is 32 zones (one per lane) by 16 warps; the block stages its
//     zones' vertices in shared memory with coalesced loads and computes
//     every edge's guarded slope there once, then each lane holds its
//     zone's x, y and slope in registers (three floats an edge);
//   * the grid is one wave: blocks_per_sm * SMs blocks, spread over the
//     zone tiles, and each warp walks groups of 32 points of its tile
//     (group g, g + warps_per_tile, ...), so the shard's B=16384 does not
//     end on a part-filled wave;
//   * a group's 32 points are read once as float2 into the warp's shared
//     slots and broadcast from there; a lane shifts each point's parity
//     into one register (32 points, 32 bits) and writes 32 bytes of each
//     output row with its warp, a full group's stores unrolled;
//   * V up to a chunk of VC vertices is one pass over registers (slots
//     past V repeat vertex 0: their edges never straddle); above 32, the
//     chunks loop, each holding the y of the next chunk's first vertex so
//     its last edge closes, and each later chunk xors its parities into
//     the bytes the first wrote.
//
// Rounding: the slope is (x2 - x1) / (y2 - y1), the denominator 1 for a
// horizontal edge, rounded as ops/geo.py guarded_slope rounds it; the
// crossing abscissa is rounded after the multiply and after the add
// (__fmul_rn / __fadd_rn; the file is also built with -fmad=false), the
// plain version's two roundings.  An FMA would round once and could flip
// a point that lies on an edge.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;              // zones per block: one per lane
constexpr int kWarps = 16;              // warps per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kRow = kLanes + 1;        // padded shared row
constexpr int kMaxDevices = 64;
constexpr int kPointUnroll = 2;         // points a pass of the point loop

// -0 as +0 and any NaN as the canonical NaN: the staged values whose
// differences' signs are the kernel's compares.
__device__ __forceinline__ float canonical(float v) {
  return v == v ? __fadd_rn(v, 0.0f) : __int_as_float(0x7fffffff);
}

__device__ __forceinline__ float guarded_slope(float x1, float y1, float x2,
                                               float y2) {
  const float den = y2 == y1 ? 1.0f : __fsub_rn(y2, y1);
  return __fdiv_rn(__fsub_rn(x2, x1), den);
}

// Blocks an SM holds by the register budget: 2 (64 registers a thread)
// for chunks of up to 16 edges, 1 (128) for 32.
template <int VC, bool ONE_CHUNK>
__global__ void __launch_bounds__(kThreads, VC <= 16 ? 2 : 1)
pip_parity_kernel(const float2* __restrict__ points,
                  const float2* __restrict__ verts, uint8_t* __restrict__ out,
                  int B, int Z, int V, int zone_tiles, int warps_per_tile) {
  __shared__ float sx[VC + 1][kRow];
  __shared__ float sy[VC + 1][kRow];
  __shared__ float ss[VC][kRow];
  __shared__ float2 spts[kWarps][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int z0 = (blockIdx.x % zone_tiles) * kLanes;
  const int z = z0 + lane;
  const int first_group = (blockIdx.x / zone_tiles) * kWarps + warp;
  const int groups = (B + kLanes - 1) / kLanes;
  const int n_chunks = ONE_CHUNK ? 1 : (V + VC - 1) / VC;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int v0 = chunk * VC;
    if (chunk > 0) __syncthreads();     // every lane holds the last chunk
    // Slot i of the chunk is vertex v0 + i, or vertex 0 past the ring's
    // end; a zone past Z is all zeros (it never straddles, never stored).
    for (int t = threadIdx.x; t < kLanes * (VC + 1); t += kThreads) {
      const int zl = t / (VC + 1), i = t % (VC + 1);
      const int v = v0 + i < V ? v0 + i : 0;
      const float2 p = z0 + zl < Z
          ? verts[static_cast<size_t>(z0 + zl) * V + v] : make_float2(0.f, 0.f);
      sx[i][zl] = canonical(p.x);
      sy[i][zl] = canonical(p.y);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kLanes * VC; t += kThreads) {
      const int i = t / kLanes, zl = t % kLanes;
      ss[i][zl] = guarded_slope(sx[i][zl], sy[i][zl], sx[i + 1][zl],
                                sy[i + 1][zl]);
    }
    __syncthreads();

    float x[VC], y[VC], s[VC];
#pragma unroll
    for (int i = 0; i < VC; ++i) {
      x[i] = sx[i][lane];
      y[i] = sy[i][lane];
      s[i] = ss[i][lane];
    }
    const float y_next = sy[VC][lane];  // the next chunk's first vertex

    for (int g = first_group; g < groups; g += warps_per_tile) {
      const int b0 = g * kLanes;
      __syncwarp();                     // the last group's points are read
      const float2 q = b0 + lane < B ? points[b0 + lane]
                                     : make_float2(0.f, 0.f);
      spts[warp][lane] = make_float2(canonical(q.x), canonical(q.y));
      __syncwarp();
      // point j's parity ends in bit 31 - j
      uint32_t bits = 0;
#pragma unroll (kPointUnroll)
      for (int j = 0; j < kLanes; ++j) {
        const float2 p = spts[warp][j];
        const float d_first = __fsub_rn(p.y, y[0]);
        float d_v = d_first;
        uint32_t parity = 0;          // in its sign bit
#pragma unroll
        for (int i = 0; i < VC; ++i) {
          // one y-compare per vertex: d of the vertex ending edge i is
          // the d that starts edge i + 1
          const float d_n = i + 1 < VC ? __fsub_rn(p.y, y[i + 1])
                                       : (ONE_CHUNK ? d_first
                                                    : __fsub_rn(p.y, y_next));
          const float x_cross = __fadd_rn(__fmul_rn(s[i], d_v), x[i]);
          const float e = __fsub_rn(p.x, x_cross);
          parity ^= (__float_as_uint(d_v) ^ __float_as_uint(d_n))
                    & __float_as_uint(e);
          d_v = d_n;
        }
        bits = __funnelshift_l(parity, bits, 1);
      }
      if (z >= Z) continue;
      // bit 31 is the group's next point; each row gets its byte
      uint8_t* o = out + static_cast<size_t>(b0) * Z + z;
      const int n = B - b0 < kLanes ? B - b0 : kLanes;
      if (n == kLanes && (ONE_CHUNK || chunk == 0)) {
#pragma unroll
        for (int j = 0; j < kLanes; ++j, o += Z, bits <<= 1) {
          *o = static_cast<uint8_t>(bits >> 31);
        }
        continue;
      }
      for (int j = 0; j < n; ++j, o += Z, bits <<= 1) {
        *o = static_cast<uint8_t>((bits >> 31) ^ (chunk > 0 ? *o : 0u));
      }
    }
  }
}

struct Plan {
  int vc, one_chunk, blocks_per_sm, sms, zone_tiles, warps_per_tile, grid,
      groups, regs, local_bytes;
};

template <int VC, bool ONE_CHUNK>
cudaError_t plan_for(int B, int Z, int device, Plan* p) {
  // the occupancy and SM count of each card, asked once
  static std::atomic<int> occupancy[kMaxDevices], sm_count[kMaxDevices];
  const auto kernel = pip_parity_kernel<VC, ONE_CHUNK>;
  int per_sm = occupancy[device].load(std::memory_order_relaxed);
  int sms = sm_count[device].load(std::memory_order_relaxed);
  if (per_sm == 0 || sms == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    occupancy[device].store(per_sm, std::memory_order_relaxed);
    sm_count[device].store(sms, std::memory_order_relaxed);
  }
  const int zone_tiles = (Z + kLanes - 1) / kLanes;
  const int groups = (B + kLanes - 1) / kLanes;
  int per_tile = per_sm * sms / zone_tiles;
  const int needed = (groups + kWarps - 1) / kWarps;
  per_tile = per_tile < 1 ? 1 : (per_tile > needed ? needed : per_tile);
  *p = Plan{VC, ONE_CHUNK, per_sm, sms, zone_tiles, per_tile * kWarps,
            zone_tiles * per_tile, groups, 0, 0};
  return cudaSuccess;
}

template <int VC, bool ONE_CHUNK>
cudaError_t launch(const float2* points, const float2* verts, uint8_t* out,
                   int B, int Z, int V, int device, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan_for<VC, ONE_CHUNK>(B, Z, device, &p);
  if (err != cudaSuccess) return err;
  pip_parity_kernel<VC, ONE_CHUNK><<<p.grid, kThreads, 0, stream>>>(
      points, verts, out, B, Z, V, p.zone_tiles, p.warps_per_tile);
  return cudaGetLastError();
}

template <int VC, bool ONE_CHUNK>
cudaError_t describe(int B, int Z, int device, Plan* p) {
  cudaError_t err = plan_for<VC, ONE_CHUNK>(B, Z, device, p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pip_parity_kernel<VC, ONE_CHUNK>);
  p->regs = attr.numRegs;
  p->local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

// Runs fn on `device`, the caller's current device restored after.
template <typename Fn>
int on_device(int device, Fn fn) {
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fn();
  if (current >= 0 && current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

// The plain C entry points bound with ctypes; each returns a cudaError_t,
// 0 on success.  Any V >= 1: up to 32 one chunk, above that a loop.

// Launch on `stream` of card `device`: points float32[B, 2], verts
// float32[Z, V, 2], both contiguous and 8-byte aligned, out uint8[B, Z].
extern "C" int sw_pip_launch(const void* points, const void* verts,
                             void* out, int B, int Z, int V, int device,
                             void* stream) {
  if (B <= 0 || Z <= 0 || V <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* pts = static_cast<const float2*>(points);
  const auto* vts = static_cast<const float2*>(verts);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    if (V <= 4) return launch<4, true>(pts, vts, o, B, Z, V, device, st);
    if (V <= 8) return launch<8, true>(pts, vts, o, B, Z, V, device, st);
    if (V <= 16) return launch<16, true>(pts, vts, o, B, Z, V, device, st);
    if (V <= 32) return launch<32, true>(pts, vts, o, B, Z, V, device, st);
    return launch<32, false>(pts, vts, o, B, Z, V, device, st);
  });
}

// The launch sw_pip_launch makes for (B, Z, V) on `device`, as 10 ints:
// chunk VC, one chunk (0/1), blocks per SM, SMs, zone tiles, warps per
// zone tile, grid, groups of 32 points, registers a thread, local
// (spilled) bytes a thread.
extern "C" int sw_pip_plan(int B, int Z, int V, int device, int* plan) {
  if (B <= 0 || Z <= 0 || V <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p{};
  const int rc = on_device(device, [&]() {
    if (V <= 4) return describe<4, true>(B, Z, device, &p);
    if (V <= 8) return describe<8, true>(B, Z, device, &p);
    if (V <= 16) return describe<16, true>(B, Z, device, &p);
    if (V <= 32) return describe<32, true>(B, Z, device, &p);
    return describe<32, false>(B, Z, device, &p);
  });
  const int vals[10] = {p.vc, p.one_chunk, p.blocks_per_sm, p.sms,
                        p.zone_tiles, p.warps_per_tile, p.grid, p.groups,
                        p.regs, p.local_bytes};
  for (int i = 0; i < 10; ++i) plan[i] = vals[i];
  return rc;
}
