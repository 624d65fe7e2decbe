// Point-in-polygon parity kernel for the geofence stage, for Hopper (sm_90a).
//
// Replaces the TPU kernel sitewhere_tpu/ops/geo_pallas.py:_pip_kernel (:41),
// launched there by points_in_polygons_pallas (:68, pallas_call at :104).
// It computes the same function: for each point b and polygon z, the parity
// of ray crossings over the polygon's V edges, out[b, z] = 1 when odd.
//
// Inputs (laid out by the wrapper, sitewhere_tpu_torch/ops/geo_cuda.py):
//   px, py                float32[B]   point coordinates (lon, lat)
//   y1, y2, x1, slope     float32[V, Z] edge planes, vertex-major; slope is
//                         (x2 - x1) / (y2 - y1) with the denominator guarded
//                         for horizontal edges, computed outside the kernel
//                         exactly as geo_pallas.py:89-98 does
//   out                   uint8[B, Z]  (a torch.bool tensor's bytes)
//
// What bounds it on the card: arithmetic.  B*Z*V edge tests of a few float
// operations each against B*Z bytes written (at B=131072, Z=512, V=16:
// 2^30 tests, 64 MiB out), so the design keeps every operand in registers:
//   * a block is 32 zones (one per lane) by 8 warps; each lane holds a chunk
//     of VC <= 32 of its zone's edges in registers (loaded once per chunk,
//     coalesced across lanes), so edges never touch shared memory;
//   * the block's TILE_B points are staged once in shared memory and read
//     as warp-wide broadcasts;
//   * a lane's 32 points (one per 8 rows of the tile) keep their parity as
//     the bits of one register, so any V is a loop over chunks of VC edges
//     (V <= 32 is one chunk);
//   * for each point a warp writes 32 neighbouring bytes of one output row.
//
// Rounding: the crossing abscissa slope * (py - y1) + x1 is rounded after
// the multiply and after the add (__fmul_rn / __fadd_rn; the file is also
// built with -fmad=false), the same two roundings as the plain PyTorch
// version, which runs the multiply and the add as separate kernels.  An FMA
// would round once and could flip a point that lies on an edge.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileZ = 32;        // zones per block: one per lane
constexpr int kWarps = 8;         // warps per block
constexpr int kTileB = 256;       // points per block

constexpr int kPointsPerLane = kTileB / kWarps;
static_assert(kPointsPerLane == 32, "a lane's parities are one uint32");

template <int VC>
__global__ void __launch_bounds__(kTileZ * kWarps)
pip_parity_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ y1p, const float* __restrict__ y2p,
                  const float* __restrict__ x1p, const float* __restrict__ sp,
                  uint8_t* __restrict__ out, int B, int Z, int V) {
  __shared__ float spx[kTileB];
  __shared__ float spy[kTileB];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b0 = blockIdx.x * kTileB;
  const int z = blockIdx.y * kTileZ + lane;
  const bool z_ok = z < Z;

  // Stage the block's points; points past B are zeros, never stored.
  for (int i = warp * kTileZ + lane; i < kTileB; i += kTileZ * kWarps) {
    const int b = b0 + i;
    spx[i] = b < B ? px[b] : 0.0f;
    spy[i] = b < B ? py[b] : 0.0f;
  }
  __syncthreads();

  // Bit j: parity of tile row warp + j * kWarps against zone z.
  uint32_t bits = 0;
  for (int v0 = 0; v0 < V; v0 += VC) {
    // This lane's chunk of zone edges; a zone past Z gets degenerate edges
    // (y1 == y2 never straddles), and its result is never stored.
    float y1[VC], y2[VC], x1[VC], s[VC];
#pragma unroll
    for (int v = 0; v < VC; ++v) {
      const size_t k = static_cast<size_t>(v0 + v) * Z + z;
      y1[v] = z_ok ? y1p[k] : 0.0f;
      y2[v] = z_ok ? y2p[k] : 0.0f;
      x1[v] = z_ok ? x1p[k] : 0.0f;
      s[v] = z_ok ? sp[k] : 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < kPointsPerLane; ++j) {
      const int i = warp + j * kWarps;
      const float x = spx[i];
      const float y = spy[i];
      uint32_t parity = 0;
#pragma unroll
      for (int v = 0; v < VC; ++v) {
        const bool straddles = (y1[v] > y) != (y2[v] > y);
        const float x_cross = __fadd_rn(__fmul_rn(s[v], __fsub_rn(y, y1[v])), x1[v]);
        parity ^= static_cast<uint32_t>(straddles && (x < x_cross));
      }
      bits ^= parity << j;
    }
  }

  if (!z_ok) return;
  for (int j = 0; j < kPointsPerLane; ++j) {
    const int b = b0 + warp + j * kWarps;
    if (b >= B) break;
    out[static_cast<size_t>(b) * Z + z] = static_cast<uint8_t>((bits >> j) & 1u);
  }
}

template <int VC>
cudaError_t launch(const float* px, const float* py, const float* y1,
                   const float* y2, const float* x1, const float* slope,
                   uint8_t* out, int B, int Z, int V, cudaStream_t stream) {
  const dim3 block(kTileZ, kWarps);
  const dim3 grid((B + kTileB - 1) / kTileB, (Z + kTileZ - 1) / kTileZ);
  pip_parity_kernel<VC><<<grid, block, 0, stream>>>(px, py, y1, y2, x1, slope,
                                                     out, B, Z, V);
  return cudaGetLastError();
}

}  // namespace

// The plain C entry point bound with ctypes.  V must be 4, 8, 16 or a
// multiple of 32 (the wrapper pads the edge planes up with degenerate
// edges).  Returns the launch's cudaError_t; 0 means launched.
extern "C" int sw_pip_launch(const float* px, const float* py,
                             const float* y1, const float* y2,
                             const float* x1, const float* slope,
                             uint8_t* out, int B, int Z, int V,
                             void* stream) {
  if (B <= 0 || Z <= 0 || (Z + kTileZ - 1) / kTileZ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (V) {
    case 4: return static_cast<int>(launch<4>(px, py, y1, y2, x1, slope, out, B, Z, V, st));
    case 8: return static_cast<int>(launch<8>(px, py, y1, y2, x1, slope, out, B, Z, V, st));
    case 16: return static_cast<int>(launch<16>(px, py, y1, y2, x1, slope, out, B, Z, V, st));
    default:
      if (V <= 0 || V % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<32>(px, py, y1, y2, x1, slope, out, B, Z, V, st));
  }
}
